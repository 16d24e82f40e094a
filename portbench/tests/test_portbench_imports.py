"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from portbench import core

PORT = ("distkeras_tpu_torch", "distkeras_torch")


def _run(code: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_whole_names_are_compared(monkeypatch):
    before = core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "distkeras_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxx", sys)
    assert core.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in core.forbidden_modules()


def test_a_run_loads_no_jax():
    """Every module a run loads (harness, drivers, readers, reference and
    the port's trainers, engines, models and kernels' wrappers): a tiny
    run of each cell on the CPU, then ``sys.modules`` by whole names."""
    code = (
        "import sys, json\n"
        "from portbench import core, run, calibrate, faults\n"
        "from portbench.tests.conftest import tiny, CELLS\n"
        "for c in CELLS:\n"
        "    b = tiny(c)\n"
        "    res, rc = run.run(b, 3, 0.05, False, device='cpu')\n"
        "    res, rc = run.run(b, 3, 0.05, True, device='cpu')\n"
        "    for m in b.per_layer + b.end_to_end: core.load_reader(m['name'])\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(tops))\n")
    tops = set(eval(_run(code)))
    assert "distkeras_tpu_torch" in tops and "portbench" in tops
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, json\n"
            "import portbench.reference.train, portbench.reference.lm\n"
            "import portbench.reference.numerics\n"
            "import portbench.reference.rules.adag\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    tops = set(eval(_run(code)))
    assert not tops & set(PORT + core.FORBIDDEN)


def test_reference_sources_name_no_port_module():
    for path in glob.glob(os.path.join(core.HERE, "reference", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top in ("torch", "portbench", "__future__",
                               "importlib", "math"), (path, n)
                if top == "portbench":
                    assert n.startswith("portbench.reference"), (path, n)
