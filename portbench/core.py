"""The harness's own parts: a cell's files found by name, the weights and
the traffic made from the seed, and the comparison that decides
``correct``.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``. Its files:
``configs/<config>.json`` (the model's settings), ``traffic/<traffic>.json``
(the parameters its generator reads) and ``cells/<cell>.json`` (the
driver, the trainer's settings, the window's epoch and the limits of the
comparison). The traffic file's ``kind`` names its generator,
``traffic/kinds/<kind>.py``. A metric is ``metrics/<metric>.py``, or the
file of the name's first part (``device_idle.py`` reads
``device_idle.tokens``), whose ``read(ctx)`` returns a number or None.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "distkeras_tpu", "distkeras")
#: how many windows (steps) of the timed path the reference follows
CHECKED_WINDOWS = 3


def _checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, _checked_name(name) + ".json")) as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_file(kind: str, name: str):
    """``<kind>/<name>.py`` as a module, loaded by path (names hold dots,
    which an import would read as packages)."""
    path = os.path.join(HERE, kind, _checked_name(name) + ".py")
    tag = re.sub(r"[^A-Za-z0-9_]", "_", kind + "." + name)
    spec = importlib.util.spec_from_file_location("portbench._" + tag, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the
    reader of its first part, which serves every suffix
    (``device_idle.tokens``, ``device_idle.samples``)."""
    for stem in (name, name.split(".")[0]):
        if os.path.exists(os.path.join(HERE, "metrics", stem + ".py")):
            return load_file("metrics", stem)
    raise FileNotFoundError(f"no reader for metric {name!r}")


def load_driver(name: str):
    return importlib.import_module("portbench.drivers." + _checked_name(name))


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``distkeras_tpu_torch`` is not ``distkeras_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Bench:
    """One cell with everything its files say."""

    name: str
    workload: dict
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list    # BENCHMARK.json's end-to-end entries of this cell
    per_layer: list     # its per-layer entries of this cell


def _applies(entry: dict, cell: str) -> bool:
    return cell in entry["workloads"] if "workloads" in entry else True


def resolve(name: str, benchmark: dict | None = None) -> Bench:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    benchmark = benchmark or load_benchmark()
    found = [w for w in benchmark["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}")
    w = found[0]
    e2e = [m for m in benchmark["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in benchmark["per_layer"]
             if (_applies(m, name) if "workloads" in m
                 else m["moves"] in moved)]
    return Bench(name=name, workload=w, cell=load_json("cells", name),
                 config=load_json("configs", w["config"]),
                 traffic=load_json("traffic", w["traffic"]),
                 end_to_end=e2e, per_layer=layer)


# -- weights and traffic from the seed -----------------------------------------

def _generator(seed: int, salt: int, device):
    """A generator on ``device`` seeded from the run's seed (any whole
    number up to 2**63) and a salt that keeps weights and data apart."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + salt) % (2 ** 63))


def make_params(shapes: dict, seed: int, device) -> dict:
    """The model's f32 parameters from ``seed`` in one draw on ``device``:
    every matrix N(0, 1/fan_in) with fan_in its last dimension (the
    ``[out, in]`` layout), every vector named ``*.weight`` ones (a
    LayerNorm's scale) and every other vector zeros. The matrices are
    views of one buffer."""
    mats = [(n, tuple(s)) for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(s) for _, s in mats)
    gen = _generator(seed, 1, device)
    buf = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for n, s in mats:
        k = math.prod(s)
        out[n] = buf[off:off + k].view(s).mul_(s[-1] ** -0.5)
        off += k
    for n, s in shapes.items():
        if len(s) < 2:
            fill = torch.ones if n.endswith("weight") else torch.zeros
            out[n] = fill(tuple(s), device=device)
    return {n: out[n] for n in shapes}


def make_columns(traffic: dict, config: dict, lead: int, rows: int,
                 seed: int, device) -> tuple:
    """The traffic's columns ``[lead, rows, …]`` on ``device`` from
    ``seed``, made by the generator that the traffic file's ``kind``
    names, ``traffic/kinds/<kind>.py``: its ``columns(traffic, config,
    lead, rows, gen, device)``. A generator gives every seed the same
    work (lengths, sizes), so that the work does not depend on it."""
    gen = _generator(seed, 2, device)
    return load_file(os.path.join("traffic", "kinds"),
                     traffic["kind"]).columns(traffic, config, lead, rows,
                                              gen, device)


def window_slices(columns: tuple, lead: int, window: int, batch: int,
                  count: int) -> list:
    """The first ``count`` windows of pool columns ``[lead, rows, …]`` as
    tuples of ``[lead, window, batch, …]``, in the order the engines walk
    their staged rows."""
    per = window * batch
    return [tuple(c[:, s * per:(s + 1) * per].reshape(
        (lead, window, batch) + tuple(c.shape[2:])) for c in columns)
        for s in range(count)]


# -- the comparison that decides `correct` ---------------------------------------

def leaf_norms(tree: dict) -> dict:
    """``{leaf: ‖leaf‖₂}`` in f32, read to the host in one copy."""
    names = list(tree)
    norms = torch.stack([torch.linalg.vector_norm(
        tree[n].detach().to(torch.float32)) for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def worst_leaf_gap(prog: dict, ref: dict, keep=None):
    """``(gap, leaf)``: the largest ``|‖p‖ − ‖r‖|`` over the leaves, each
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = statistics.median(ref.values())
    worst, leaf = 0.0, None
    for n, r in ref.items():
        if keep is not None and n not in keep:
            continue
        g = abs(prog[n] - r) / max(r, med, 1e-30)
        if not g <= worst:      # a NaN counts as the worst
            worst, leaf = g, n
    return worst, leaf


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, from two readings ``{"loss": [window
    losses], "grad": {leaf: norm}, "change": {leaf: norm}}``:

    - ``loss``: the largest gap of a checked window's loss, relative;
    - ``grad``: worst leaf of Adam's first moment after the first window
      (the gradients as the optimizer got them);
    - ``change``: worst leaf of the center's change over the checked
      windows, leaving out the leaves whose reference ``grad`` is under
      a thousandth of the median leaf's (they move by round-off alone).

    Returns ``{name: (value, leaf or None)}``."""
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["loss"], ref["loss"])]
    loss = max(gaps) if len(prog["loss"]) == len(ref["loss"]) and all(
        math.isfinite(g) for g in gaps) else math.inf
    med = statistics.median(ref["grad"].values())
    keep = {n for n, g in ref["grad"].items() if g >= 1e-3 * med}
    return {"loss": (loss, None),
            "grad": worst_leaf_gap(prog["grad"], ref["grad"]),
            "change": worst_leaf_gap(prog["change"], ref["change"], keep)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number finite and
    at most its limit."""
    checks = {n: {"value": v, "limit": float(limits[n])}
              for n, (v, _) in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
