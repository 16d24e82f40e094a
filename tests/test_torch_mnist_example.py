"""The port's MNIST example (``python -m distkeras_tpu_torch.examples.mnist``,
the twin of ``examples/mnist.py``) runs end to end on the CPU: transformers
→ trainer → predictor → evaluator, through the collective backend and
through the parameter server, to the JAX example's gate (test accuracy >
0.8 on the synthetic stand-in)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_twin(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"   # one small MLP: threads only contend
    return subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.examples.mnist",
         "--device", "cpu", "--model", "mlp", "--rows", "2048",
         "--epochs", "1", "--batch-size", "32", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [
    (), ("--backend", "ps", "--compression", "int8", "--workers", "2")],
    ids=["collective", "ps"])
def test_mnist_twin_runs_end_to_end(extra):
    proc = run_twin(*extra)
    assert proc.returncode == 0, proc.stderr[-2000:]
    acc = float(proc.stdout.rsplit("test accuracy:", 1)[1].strip())
    assert acc > 0.8, proc.stdout


def test_mnist_twin_later_flags_name_their_item():
    """``--frontend keras`` now runs (``tests/test_torch_keras.py``), and so
    does ``--ema`` (``test_mnist_twin_scores_the_ema``); the flags still of
    a later slice name their item."""
    proc = run_twin("--int8-predict")
    assert proc.returncode == 2 and "A11.5" in proc.stderr, proc.stderr


def test_mnist_twin_scores_the_ema():
    """``--ema DECAY`` trains with the center's Polyak average and scores
    the averaged model too, before the final ``test accuracy`` line."""
    proc = run_twin("--ema", "0.9")
    assert proc.returncode == 0, proc.stderr[-2000:]
    ema_acc = float(proc.stdout.split("EMA(decay=0.9) accuracy:", 1)[1]
                    .split("\n", 1)[0])
    acc = float(proc.stdout.rsplit("test accuracy:", 1)[1].strip())
    assert acc > 0.8 and ema_acc > 0.8, proc.stdout
