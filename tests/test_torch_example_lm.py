"""The port's LM example (``python -m distkeras_tpu_torch.examples.lm``,
the twin of ``examples/lm.py``).

- Its decodes against the JAX package's: an LM trained on the cyclic
  language by the JAX package, its weights carried into the port's served
  module with ``convert.params_from_jax``, then the twin's greedy
  ``generate``, best beam of ``beam_search`` (4 beams) and int8
  ``generate`` (``quantize_lm``) give the JAX package's tokens exactly, in
  f32, and each clears the example's 0.9 continuation accuracy.
- The twin end to end on the CPU (``--quick --device cpu``), and with
  RoPE + GQA + a sliding window: exit 0 and ``OK``, the JAX example's own
  self-check.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jtrainers
from distkeras_tpu.models import beam_search as jbeam_search
from distkeras_tpu.models import generate as jgenerate
from distkeras_tpu.models import next_token_dataset as jnext_token_dataset
from distkeras_tpu.models import quantize_lm as jquantize_lm
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.examples import lm as twin
from distkeras_tpu_torch.models import transformer_lm

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(vocab=64, maxlen=64, dim=32, heads=4, depth=2)
SEQ = 32


@pytest.fixture(scope="module")
def trained():
    """The cyclic language, and an LM the JAX package trained on it."""
    rows = twin.cyclic_rows(1024, SEQ, CFG["vocab"])
    spec = jtransformer_lm(dtype=jnp.float32, **CFG)
    t = jtrainers.SingleTrainer(
        spec, loss="sparse_softmax_cross_entropy", worker_optimizer="adam",
        learning_rate=3e-3, batch_size=64, num_epoch=4, label_col="label")
    params = t.train(jnext_token_dataset(rows.astype(np.int32)),
                     shuffle=True)
    return rows, spec, params


def test_twin_decodes_equal_the_jax_package(trained):
    rows, spec, params = trained
    model = params_from_jax(params, transformer_lm(
        dtype=torch.float32, device="cpu", **CFG))
    got = twin.decode_checks(model, rows)
    assert list(got) == ["generate", "beam", "int8"], got

    prompts = rows[:4, :twin.N_PROMPT].astype(np.int32)
    want = {
        "generate": jgenerate(spec, params, prompts, twin.N_NEW),
        "beam": jbeam_search(spec, params, prompts, twin.N_NEW,
                             beams=4)[0][:, 0],
        "int8": jgenerate(*jquantize_lm(spec, params), prompts,
                          twin.N_NEW),
    }
    for name, (acc, toks) in got.items():
        np.testing.assert_array_equal(toks, np.asarray(want[name]),
                                      err_msg=name)
        assert acc >= twin.ACC_BAR, (name, acc)


def run_twin(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.examples.lm",
         "--device", "cpu", "--quick", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [
    (), ("--pos", "rope", "--kv-heads", "2", "--window", "16")],
    ids=["default", "rope_gqa_window"])
def test_twin_runs_and_generates(extra):
    proc = run_twin(*extra)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.rstrip().endswith("OK"), proc.stdout
    for tag in ("[train]", "[generate]", "[beam-4]", "[generate:int8]"):
        assert tag in proc.stdout, (tag, proc.stdout)
