"""Guards of the port's boundaries: distkeras_tpu_torch imports no JAX and
nothing of the JAX package, and its entry points run on the card unless
the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.models import (
    lstm_classifier,
    transformer_classifier,
    transformer_lm,
    transformer_lm_spec,
)
from distkeras_tpu_torch.ops.flash_attention import (
    _fa_backward,
    flash_attention,
)
from distkeras_tpu_torch.ops.pallas_kernels import fused_adam_step
from distkeras_tpu_torch.ops.quant import q_matmul, quantize
from distkeras_tpu_torch.ops.recurrent import lstm_backward, lstm_forward
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distkeras_tpu_torch.serving import GenerationEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import distkeras_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ml_dtypes", "keras", "distkeras_tpu",
                                    "distkeras"))
missing = sorted(set(sys.argv[1:]) - set(names))
print(len(names), missing, bad)
"""

#: the modules of the parameter-server slices and the user surface: each
#: must be among those the probe imports
_NEW_MODULES = ["transformers", "evaluators", "predictors",
                "parameter_servers", "workers", "observability.trace",
                "parallel.compression", "examples.mnist", "shm", "native",
                "native_ps", "model", "resilience", "resilience.heartbeat",
                "resilience.retry", "resilience.faults", "resilience.wal",
                "resilience.recovery", "sharding", "sharding.ring",
                "sharding.client", "sharding.group", "checkpoint",
                "observability.timeseries", "observability.watch",
                "resilience.elastic", "directory", "directory.service",
                "directory.client", "directory.host", "directory.router",
                "deploy", "deploy.stream", "deploy.rollout",
                "examples.lm", "examples.longcontext",
                "examples.parallelism", "examples.serve_lm",
                "examples.train_while_serving"]

#: the JAX package's names no module, twin or notebook of the port may
#: import
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "keras",
              "distkeras_tpu", "distkeras")

_ALIAS_PROBE = r"""
import sys
import distkeras_torch
from distkeras_torch.trainers import ADAG
from distkeras_torch.evaluators import AccuracyEvaluator
import distkeras_tpu_torch
import distkeras_tpu_torch.evaluators as evaluators
assert ADAG is distkeras_tpu_torch.trainers.ADAG is distkeras_torch.ADAG
assert AccuracyEvaluator is evaluators.AccuracyEvaluator
assert distkeras_torch.trainers is distkeras_tpu_torch.trainers
print(sorted(m for m in sys.modules if m.split(".")[0] in %r))
""" % (_FORBIDDEN,)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the package, the shm and native transports and the
    sharded center among them, imports in a fresh process without jax, flax, optax, keras or
    anything of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _PROBE,
         *(f"distkeras_tpu_torch.{m}" for m in _NEW_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.strip().split(" ", 1)
    missing, bad = rest.split("] ", 1)
    assert int(n) >= 45, out.stdout          # every module was imported
    assert missing == "[", f"modules not found: {missing}]"
    assert bad == "[]", f"forbidden modules imported: {bad}"


def test_distkeras_torch_alias_is_the_port_without_jax():
    """``import distkeras_torch`` (the reference's ``distkeras`` import
    form on the port) registers the port's modules under its name and
    loads no JAX in a fresh process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _ALIAS_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_workflow_notebook_imports_no_jax():
    """No cell of the port's notebook imports JAX or the JAX package."""
    import json
    import re

    from distkeras_tpu_torch.examples import WORKFLOW

    names = "|".join(_FORBIDDEN)
    pat = re.compile(rf"^\s*(?:import|from)\s+(?:{names})\b", re.M)
    cells = json.loads(WORKFLOW.read_text())["cells"]
    code = ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]
    assert code and "distkeras_tpu_torch" in code[0]
    for src in code:
        assert not pat.search(src), src


@pytest.mark.parametrize("name", ["lm", "longcontext", "parallelism",
                                  "serve_lm", "train_while_serving"])
def test_example_twins_default_to_cuda(name):
    """Each example twin runs on the card unless given ``--device cpu``;
    without a card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    import importlib

    twin = importlib.import_module(f"distkeras_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main(["--quick"])


def test_entry_points_default_to_cuda():
    """Without device= the port asks for the card; on a machine without
    one it raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer_lm(vocab=32, maxlen=32, dim=16, heads=2, depth=1)
    model = transformer_lm(vocab=32, maxlen=32, dim=16, heads=2, depth=1,
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(model)
    eng = GenerationEngine(model, device="cpu")
    assert eng.cache.k_pools[0].device.type == "cpu"


@pytest.mark.parametrize("cls", ["SingleTrainer", "ADAG", "DOWNPOUR",
                                 "AEASGD", "EAMSGD", "DynSGD"])
def test_trainers_default_to_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    spec = lstm_classifier(vocab=50, embed_dim=8, hidden_dim=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(trainers, cls)(spec)
    assert getattr(trainers, cls)(spec, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("spec_fn", ["transformer_lm_spec",
                                     "transformer_classifier"])
def test_transformer_training_defaults_to_cuda(spec_fn):
    """The transformer training entry points (their specs are device-free
    descriptions, as in the JAX package) train on the card unless the
    trainer is given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    make = {"transformer_lm_spec": lambda: transformer_lm_spec(
                vocab=32, maxlen=16, dim=16, heads=2, depth=1,
                fused_ce=True),
            "transformer_classifier": lambda: transformer_classifier(
                vocab=32, maxlen=16, dim=16, heads=2, depth=1)}[spec_fn]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainers.ADAG(make())
    assert trainers.ADAG(make(), device="cpu").device.type == "cpu"


def test_ps_backend_predictor_and_mnist_twin_default_to_cuda():
    """The parameter-server trainer, the predictor and the MNIST example
    run on the card unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    from distkeras_tpu_torch.examples import mnist as mnist_twin
    from distkeras_tpu_torch.models import mlp
    from distkeras_tpu_torch.predictors import ModelPredictor

    spec = mlp(input_shape=(4,), hidden=(4,), num_classes=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainers.DynSGD(spec, backend="ps", ps_transport="socket")
    assert trainers.DynSGD(spec, backend="ps",
                           device="cpu").device.type == "cpu"
    params, _ = spec.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelPredictor(spec, params)
    assert ModelPredictor(spec, params, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mnist_twin.main(["--model", "mlp", "--rows", "256"])


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    spec = lstm_classifier(vocab=50, embed_dim=8, hidden_dim=16)
    args = (spec, lambda p, n, b: (0.0, n), trainers.resolve_optimizer(
        "sgd", 0.1), trainers.ADAGMerge())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalSGDEngine(*args)
    assert LocalSGDEngine(*args, device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_cpu_or_cuda_tensors_only():
    qt = quantize(torch.ones(4, 8), axis=1)
    x = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        q_matmul(x, qt)
    q = torch.ones(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)
    np.testing.assert_array_equal(q_matmul(torch.ones(2, 8), qt).numpy(),
                                  np.full((2, 4), 8.0, np.float32))
    g = torch.ones(1, 2, 3, 64, device="meta")
    wh = torch.ones(1, 16, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_forward(g, wh, True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_backward(g, wh, g[..., :16], g[..., :16], g[..., :16])
    m = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_adam_step([m], [m], [m], 1, 1e-3)
    lse = torch.ones(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        _fa_backward(q, q, q, None, q, lse, q, scale=1.0, causal=True)
