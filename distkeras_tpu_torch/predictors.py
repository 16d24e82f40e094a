"""Inference path: map a trained model over a Dataset.

Port of ``distkeras_tpu/predictors.py`` (``ModelPredictor``,
``LabelIndexPredictor``): ``predict(ds)`` appends a ``'prediction'`` column
computed by one batched forward per fixed-size chunk under
``torch.no_grad()`` on the predictor's device (the card unless the caller
asks for the CPU). Rows are padded to a static batch
(``data.padded_chunks``) and the pad rows trimmed on the host.
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
    ``trained_params_`` / ``trained_nt_``."""

    def __init__(self, model, params=None, state=None,
                 features_col="features", output_col: str = "prediction",
                 batch_size: int = 512, mesh=None, dp_axis: str = "dp",
                 quantize: bool = False, device="cuda"):
        del dp_axis
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
            raise NotImplementedError(
                "mesh= is not ported yet: ROADMAP.md A12 (meshes across "
                "cards)")
        if quantize:
            raise NotImplementedError(
                "quantize=True is not ported yet: ROADMAP.md A11.5 "
                "(quantize_serving)")
        self.device = resolve_device(device)
        self.spec = model
        self.params = _to_device(params, self.device)
        self.state = _to_device(state if state is not None else {},
                                self.device)
        self.features_col = (
            [features_col] if isinstance(features_col, str)
            else list(features_col))
        self.output_col = output_col
        self.batch_size = int(batch_size)

    def predict(self, ds: Dataset) -> Dataset:
        cols = [ds[c] for c in self.features_col]
        outs = []
        with torch.no_grad():
            for chunk, real in padded_chunks(cols, self.batch_size):
                xs = tuple(torch.tensor(c, device=self.device) for c in chunk)
                x = xs[0] if len(xs) == 1 else xs
                out, _ = self.spec.apply(self.params, self.state, x, False)
                if out.dtype == torch.bfloat16:
                    out = out.float()
                outs.append(out[:real].cpu().numpy())
        return ds.with_column(self.output_col, np.concatenate(outs))


class LabelIndexPredictor(ModelPredictor):
    """ModelPredictor that emits argmaxed class indices directly."""

    def predict(self, ds: Dataset) -> Dataset:
        out = super().predict(ds)
        return out.with_column(
            self.output_col,
            np.argmax(out[self.output_col], axis=-1).astype(np.int32))
