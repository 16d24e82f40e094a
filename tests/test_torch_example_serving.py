"""The port's serving examples on the CPU, each run as a user runs it
(``python -m ...``) and held to its JAX example's own self-checks:

- ``distkeras_tpu_torch.examples.serve_lm --quick`` (the twin of
  ``examples/serve_lm.py``), with and without ``--spec``: the cyclic LM
  trained with SingleTrainer and served to 4 concurrent clients, every
  greedy served stream bit-identical to single-request ``generate()``, the
  ``eos_id`` stream stopping at the oracle's first eos, exit 0;
- ``distkeras_tpu_torch.examples.train_while_serving --quick`` (the twin
  of ``examples/train_while_serving.py``): live ADAG folding streamed into
  two directory-registered replicas, a canary promoted and the next rolled
  back on an injected SLO fault, every stream equal to the ``generate()``
  oracle at its admitted version, the rollout journal ending in the
  rollback, exit 0.

Each subprocess is stopped by its timeout; the examples stop their own
servers and clients in ``finally``.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_twin(name, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", f"distkeras_tpu_torch.examples.{name}",
         "--device", "cpu", "--quick", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [(), ("--spec",)], ids=["plain", "spec"])
def test_serve_lm_streams_are_exact(extra):
    proc = run_twin("serve_lm", *extra)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert out.count(": OK (cyclic acc") == 4, out
    assert "MISMATCH" not in out and "FAILED" not in out, out
    assert "served 8 requests" in out, out
    if extra:
        assert "speculative" in out and "spec acceptance" in out, out
    assert out.rstrip().endswith(
        "all served streams bit-identical to generate() (incl. eos early "
        "stop)"), out


def test_train_while_serving_promotes_then_rolls_back():
    proc = run_twin("train_while_serving")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    journal = out.split("[journal] ", 1)[1].split("\n", 1)[0]
    actions = [j.split("(", 1)[0] for j in journal.split(" -> ")]
    assert actions == ["canary", "promote", "canary", "rollback"], journal
    assert "rolled back to" in out and "[router] routed_by_version=" in out
    assert "every served stream bit-identical to generate()" in out, out
