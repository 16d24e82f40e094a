"""Cells, configurations, traffic and metrics are found by name from
files, and ``BENCHMARK.json`` keeps to its contract's shape."""

from __future__ import annotations

import importlib
import json
import os
import re

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = core.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_every_cell_finds_its_files(cell):
    """The driver, the traffic's generator, the reference's model and
    merge rule and the tests' tiny cut, each by the name a file gives."""
    b = core.resolve(cell)
    drv = core.load_driver(b.cell["driver"])
    assert all(callable(getattr(drv, f))
               for f in ("Driver", "faults", "plant", "tiny"))
    kind = core.load_file(os.path.join("traffic", "kinds"), b.traffic["kind"])
    assert callable(kind.columns)
    assert callable(importlib.import_module(
        "portbench.reference." + b.config["reference"]).loss_and_grads)
    assert callable(importlib.import_module(
        "portbench.reference.rules." + b.cell["reference"]["rule"]).fold)
    assert os.path.exists(os.path.join(core.HERE, "tests", "tiny",
                                       b.workload["config"] + ".json"))
    assert b.config["name"] == b.workload["config"]
    assert set(b.cell["limits"]) == {"loss", "grad", "change"}
    assert int(b.traffic["rows_per_step"]) > 0
    assert b.workload["chips"] in (1, 4)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert callable(core.load_reader(m["name"]).read)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_a_reader_serves_every_suffix_of_its_name():
    """``device_idle.py`` reads ``device_idle.tokens`` and any later
    suffix; a name with a file of its own gets that file."""
    for name in ("device_idle.tokens", "device_idle.samples",
                 "launches_per_window.samples"):
        stem = name.split(".")[0]
        assert core.load_reader(name).__file__.endswith(stem + ".py")
    assert core.load_reader("mfu.tokens").__file__.endswith("mfu.tokens.py")


def test_every_cell_reports_what_the_contract_asks(cell):
    b = core.resolve(cell)
    e2e = {m["name"] for m in b.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert b.per_layer
    assert all(m["moves"] in e2e for m in b.per_layer)


def test_configs_files_and_names():
    files = {c["file"] for c in BENCH["configs"]}
    assert len(files) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        with open(os.path.join(core.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_metrics_name_their_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
