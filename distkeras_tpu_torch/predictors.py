"""Inference path: map a trained model over a Dataset.

Port of ``distkeras_tpu/predictors.py`` (``ModelPredictor``,
``LabelIndexPredictor``, ``GeneratorPredictor``): ``predict(ds)`` appends a
``'prediction'`` column computed by one batched forward per fixed-size
chunk under ``torch.no_grad()`` on the predictor's device (the card unless
the caller asks for the CPU); ``quantize=True`` serves the zoo's Dense
layers in int8 (``ops.quant.quantize_serving``). Rows are padded to a
static batch (``data.padded_chunks``) and the pad rows trimmed on the
host. ``mesh=`` (a ``parallel.mesh.Mesh``, one process a card) spreads
each chunk's rows over the ranks of ``dp_axis``: every rank applies its
``batch_size / dp`` rows and the outputs are all-gathered, so every rank
returns the whole column. ``GeneratorPredictor`` maps the LM's
dense-cache decoding over a column of prompts.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data import Dataset, padded_chunks
from distkeras_tpu_torch.model import ModelSpec, from_keras
from distkeras_tpu_torch.utils import resolve_device, tree_map


def _to_device(tree, device):
    """A copy of every leaf on ``device``: a CPU tensor handed in must not
    share memory with the predictor's own."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device)
                    if not isinstance(x, torch.Tensor)
                    else x.detach().to(device, copy=True), tree)


class ModelPredictor:
    """Append a prediction column computed by a trained model: a Keras 3
    model (torch backend) with its weights already trained, or a
    ``ModelSpec`` plus explicit ``(params, state)`` trees, e.g. a trainer's
    ``trained_params_`` / ``trained_nt_``. With ``mesh`` every rank of the
    mesh calls ``predict`` on the same dataset (on the mesh's device)."""

    def __init__(self, model, params=None, state=None,
                 features_col="features", output_col: str = "prediction",
                 batch_size: int = 512, mesh=None, dp_axis: str = "dp",
                 quantize: bool = False, device="cuda"):
        if isinstance(model, ModelSpec):
            if params is None:
                raise ValueError("ModelSpec predictor needs explicit params")
        elif hasattr(model, "stateless_call"):
            model = from_keras(model)
            params, state = model.init(0)
        else:
            raise TypeError(
                f"ModelPredictor takes a Keras 3 model or a "
                f"distkeras_tpu_torch ModelSpec, got {type(model)}")
        if mesh is not None:
            from distkeras_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a distkeras_tpu_torch."
                                f"parallel.mesh.Mesh, got {type(mesh)}")
            device = mesh.device
        self.device = resolve_device(device)
        self.spec = model
        self.params = _to_device(params, self.device)
        self.state = _to_device(state if state is not None else {},
                                self.device)
        if quantize:
            # int8 weight-only serving: every Dense the forward reaches
            # streams int8 weights through q_matmul; zoo specs only
            from distkeras_tpu_torch.ops.quant import quantize_serving

            self.spec, self.params = quantize_serving(
                self.spec, self.params, state=self.state)
        self.features_col = (
            [features_col] if isinstance(features_col, str)
            else list(features_col))
        self.output_col = output_col
        self.batch_size = int(batch_size)
        # data-parallel inference: each chunk's rows split over dp_axis,
        # the params replicated on every rank
        self.mesh, self._group, self._rows = mesh, None, None
        if mesh is not None:
            if dp_axis not in mesh.shape:
                raise ValueError(
                    f"dp_axis {dp_axis!r} not in mesh axes "
                    f"{tuple(mesh.shape.keys())}")
            dp = mesh.shape[dp_axis]
            if self.batch_size % dp:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by mesh "
                    f"axis '{dp_axis}' of size {dp}")
            n = self.batch_size // dp
            lo = mesh.index(dp_axis) * n
            self._group, self._rows = mesh.group(dp_axis), slice(lo, lo + n)

    def predict(self, ds: Dataset) -> Dataset:
        from distkeras_tpu_torch.parallel.mesh import _all_gather

        cols = [ds[c] for c in self.features_col]
        outs = []
        with torch.no_grad():
            for chunk, real in padded_chunks(cols, self.batch_size):
                if self._rows is not None:
                    chunk = [c[self._rows] for c in chunk]
                xs = tuple(torch.tensor(c, device=self.device) for c in chunk)
                x = xs[0] if len(xs) == 1 else xs
                out, _ = self.spec.apply(self.params, self.state, x, False)
                if out.dtype == torch.bfloat16:
                    out = out.float()
                if self._group is not None:
                    out = _all_gather(out, self._group, 0)
                outs.append(out[:real].cpu().numpy())
        return ds.with_column(self.output_col, np.concatenate(outs))


class LabelIndexPredictor(ModelPredictor):
    """ModelPredictor that emits argmaxed class indices directly."""

    def predict(self, ds: Dataset) -> Dataset:
        out = super().predict(ds)
        return out.with_column(
            self.output_col,
            np.argmax(out[self.output_col], axis=-1).astype(np.int32))


class GeneratorPredictor:
    """Map dense-cache autoregressive decoding over a Dataset of prompts:
    appends a column of newly generated tokens ``[N, max_new_tokens]``.
    ``model`` is a :class:`~distkeras_tpu_torch.models.lm.TransformerLM`
    carrying its weights, on its own device. Prompts go in fixed-size
    chunks of ``batch_size`` rows; pad rows are generated and discarded.
    ``beams > 1`` decodes with ``models.beam_search`` and keeps each row's
    best beam (sampling arguments must stay at their greedy defaults).

    ``eos_id`` stops rows at end-of-sequence on both paths (rows pad with
    ``eos_id``); ``per_row_new_tokens=True`` adds an
    ``{output_col}_new_tokens`` int32 column counting each row's real
    tokens, by the serving tier's retire rule
    (``serving.per_row_new_token_counts``)."""

    def __init__(self, model, *, features_col: str = "features",
                 output_col: str = "generated", max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 batch_size: int = 64, beams: int = 1,
                 length_penalty: float = 0.0, eos_id: int | None = None,
                 per_row_new_tokens: bool = False):
        from distkeras_tpu_torch.models.lm import TransformerLM

        if not isinstance(model, TransformerLM):
            raise TypeError(f"GeneratorPredictor needs a TransformerLM, "
                            f"got {type(model)}")
        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.batch_size = int(batch_size)
        self.beams = int(beams)
        self.length_penalty = float(length_penalty)
        self.eos_id = eos_id
        self.per_row_new_tokens = bool(per_row_new_tokens)
        if self.beams < 1:
            raise ValueError(f"beams must be >= 1, got {beams}")
        if self.beams > 1 and (self.temperature != 0.0 or top_k is not None
                               or top_p is not None):
            raise ValueError(
                "beam search is deterministic: temperature/top_k/top_p "
                "cannot be combined with beams > 1")
        if self.beams == 1 and self.length_penalty:
            raise ValueError(
                "length_penalty is a beam-search option: sampling decode "
                "(beams=1) would silently ignore it — set beams > 1")

    def predict(self, ds: Dataset) -> Dataset:
        from distkeras_tpu_torch.models.lm import beam_search, generate
        from distkeras_tpu_torch.serving import per_row_new_token_counts

        outs = []
        for i, ((chunk,), real) in enumerate(padded_chunks(
                [np.asarray(ds[self.features_col])], self.batch_size)):
            if self.beams > 1:
                toks, _ = beam_search(
                    self.model, chunk, self.max_new_tokens,
                    beams=self.beams, length_penalty=self.length_penalty,
                    eos_id=self.eos_id)
                full = toks[:, 0]   # the best beam a row
            else:
                full = generate(
                    self.model, chunk, self.max_new_tokens,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, eos_id=self.eos_id,
                    # a stream of its own a chunk: identical prompts in two
                    # chunks must not draw identical samples
                    seed=self.seed + i)
            outs.append(full[:real, chunk.shape[1]:])
        out = ds.with_column(self.output_col, np.concatenate(outs))
        if self.per_row_new_tokens:
            out = out.with_column(
                f"{self.output_col}_new_tokens",
                per_row_new_token_counts(out[self.output_col], self.eos_id))
        return out
