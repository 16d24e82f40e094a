"""Fixtures of the benchmark's own tests: each cell of ``BENCHMARK.json``
cut to a tiny size that the CPU runs in seconds. The model and its
traffic are cut by ``tests/tiny/<config>.json`` (``kwargs`` over the
configuration's, ``traffic`` over the traffic file's), the trainer by its
driver's ``tiny``; the rule and the limits stay as the cell's files say.

Tests that need the card are marked ``chip`` and decide inside the test
whether there is one."""

from __future__ import annotations

import copy
import json
import os

import pytest

from portbench import core

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


def tiny(name: str, dtype: str = "float32") -> core.Bench:
    """The cell ``name`` with its model, traffic and trainer cut to a tiny
    size."""
    b = copy.deepcopy(core.resolve(name))
    with open(os.path.join(TINY, b.workload["config"] + ".json")) as f:
        cut = json.load(f)
    b.config["kwargs"].update(cut["kwargs"], dtype=dtype)
    b.traffic.update(cut["traffic"])
    core.load_driver(b.cell["driver"]).tiny(b)
    return b


CELLS = [w["name"] for w in core.load_benchmark()["workloads"]]


@pytest.fixture(params=CELLS)
def cell(request):
    """Every cell ``BENCHMARK.json`` lists."""
    return request.param
