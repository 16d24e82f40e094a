"""The port's workflow notebook (``distkeras_tpu_torch/examples/
workflow.ipynb``, the twin of ``examples/workflow.ipynb``): the same
pipeline cells (higgs → StandardScaleTransformer → AEASGD and EAMSGD on
``mlp(input_shape=(28,), hidden=(64, 32), num_classes=2)`` →
LabelIndexPredictor → AccuracyEvaluator) on the port, executed cell by
cell from the ``.ipynb`` JSON (``examples.run_notebook``) on the CPU at
``DISTKERAS_WORKFLOW_ROWS=8192``: the last cell's own assert holds (both
trainers above 0.70 test accuracy)."""

import json

import torch

from distkeras_tpu_torch.examples import WORKFLOW, run_notebook
from tests.test_torch_mesh import one_thread

JAX_NOTEBOOK = WORKFLOW.parents[2] / "examples" / "workflow.ipynb"


def _cells(path, kind):
    return ["".join(c["source"]) for c in json.loads(path.read_text())[
        "cells"] if c["cell_type"] == kind]


def test_notebook_mirrors_the_jax_notebook():
    """Cell for cell: the same sections and the same pipeline calls."""
    ours, theirs = (_cells(p, "markdown") for p in (WORKFLOW, JAX_NOTEBOOK))
    assert [c.split("\n", 1)[0] for c in ours[1:]] == \
        [c.split("\n", 1)[0] for c in theirs[1:]]
    ours, theirs = (_cells(p, "code") for p in (WORKFLOW, JAX_NOTEBOOK))
    assert len(ours) == len(theirs)
    for call in ("higgs(", "StandardScaleTransformer(", "AEASGD(",
                 "EAMSGD(", "LabelIndexPredictor(", "AccuracyEvaluator()",
                 "mlp(input_shape=(28,), hidden=(64, 32), num_classes=2)",
                 "assert all(acc > 0.70"):
        assert [call in c for c in ours] == [call in c for c in theirs], call


def test_notebook_runs_on_the_cpu(monkeypatch):
    monkeypatch.setenv("DISTKERAS_WORKFLOW_ROWS", "8192")
    monkeypatch.setenv("DISTKERAS_WORKFLOW_DEVICE", "cpu")
    with one_thread():
        ns = run_notebook()
    assert ns["DEVICE"] == "cpu"
    assert set(ns["results"]) == {"AEASGD", "EAMSGD"}
    assert all(acc > 0.70 for acc in ns["results"].values()), ns["results"]
    assert ns["aeasgd"].device == torch.device("cpu")
