"""A run's last line, and ``correct`` coming out false with the timed path
broken underneath (each fault a cell's path can have) or with the fp8
control in the port's place. The harness's look for a chip is skipped:
the tiny runs go to the CPU."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

from portbench import core, faults, run
from portbench.reference import train
from portbench.tests.conftest import CELLS, tiny


def test_result_keys_untraced_and_traced():
    b = tiny("lm9_adag_L2048")
    res, code = run.run(b, 2 ** 31 + 5, 0.05, False, device="cpu")
    assert code == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {"loss", "grad", "change"}
    json.dumps(res)
    res, code = run.run(b, 7, 0.05, True, device="cpu")
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "mfu.tokens" in res["metrics"]
    assert "train_tokens_per_s" not in res["metrics"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "lm9_adag_L2048", "--seed", "1", "--seconds", "1"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def _faults():
    return [(c, f) for c in CELLS for f in faults.for_cell(core.resolve(c))]


@pytest.mark.parametrize("cell_name,fault", _faults())
def test_a_planted_fault_is_not_correct(cell_name, fault):
    b = tiny(cell_name)
    with faults.planted(b, fault):
        res, code = run.run(b, 2 ** 31 + 99, 0.05, False, device="cpu")
    assert code == 0 and res["correct"] is False, res["checks"]


def test_the_control_is_not_correct(cell):
    """The fp8 reference in the port's place fails the cell's limits."""
    b = tiny(cell, "float32")
    layout_drv = core.load_driver(b.cell["driver"]).Driver(b, 3, "cpu")
    layout = dict(lead=layout_drv.lead, window=layout_drv.window,
                  batch=layout_drv.batch, shapes=layout_drv.shapes)
    layout_drv.release()
    ref = run.reference_readings(b, layout, 3, "cpu")
    ctrl = run.reference_readings(b, layout, 3, "cpu", precision="fp8")
    correct, checks = core.judge(core.compare(ctrl, ref), b.cell["limits"])
    assert correct is False, checks
    assert math.isfinite(checks["loss"]["value"])
    assert train.run  # the control is the reference, at another precision


@pytest.mark.chip
def test_a_cell_runs_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    b = core.resolve("lm9_adag_L2048")
    res, code = run.run(b, 2 ** 31 + 3, 1.0, False)
    assert code == 0 and res["correct"] is True, res["checks"]
