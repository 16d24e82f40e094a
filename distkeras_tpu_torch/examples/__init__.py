"""Runnable examples of the port (``python -m
distkeras_tpu_torch.examples.<name>``), and the workflow notebook
``workflow.ipynb``, which :func:`run_notebook` executes without Jupyter."""

from __future__ import annotations

import json
from pathlib import Path

#: the workflow notebook, the twin of ``examples/workflow.ipynb``
WORKFLOW = Path(__file__).with_name("workflow.ipynb")


def run_notebook(path=WORKFLOW) -> dict:
    """Execute a notebook's code cells in order in one namespace, reading
    the ``.ipynb`` with ``json`` (no ``nbformat`` needed), and return the
    namespace. A failing cell raises."""
    nb = json.loads(Path(path).read_text())
    ns: dict = {"__name__": "__main__"}
    for i, cell in enumerate(nb["cells"]):
        if cell["cell_type"] == "code":
            exec(compile("".join(cell["source"]), f"{path}#cell{i}", "exec"),
                 ns)
    return ns
