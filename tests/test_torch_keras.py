"""The port's Keras frontend (``model.from_keras``, the trainers,
``ModelPredictor``, ``serialize_keras_model``, the MNIST twin's
``--frontend keras``) on Keras 3's torch backend, held against the JAX
package's frontend on the CPU.

``tests/conftest.py`` sets ``KERAS_BACKEND=jax`` for the test process, so
every case runs in a subprocess: the port's cases in one with
``KERAS_BACKEND=torch``, the JAX package's side (and the port's refusal of
a jax-backend model) in one with ``KERAS_BACKEND=jax``; each subprocess
runs its cases once per module and reports each case's result on its own.

Tolerances: one unshuffled ADAG window of the same Keras MLP from the same
numpy-seeded weights gives centers within 1e-5 of each leaf's largest
magnitude (f32, the two packages' kernels summing in their own orders);
serde round trips predict within atol 1e-5, the JAX test's bound.
"""

import json
import os
import pathlib
import subprocess
import sys
import traceback

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_MARK = "KERAS-CASES "


def _blobs(n, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(classes, dim)).astype(np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    x = centers[labels] + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32)
    return x, labels


def _mlp(keras, extra=None, seed=None):
    """The JAX test's Keras MLP (16 → 32 relu → 4), with ``extra`` layers
    after the hidden one: Keras's own initialisation under
    ``set_random_seed(0)``, as the JAX test builds it, or with ``seed``
    every weight drawn from that numpy seed (the same numbers in both
    packages)."""
    keras.utils.set_random_seed(0)
    layers = [keras.layers.Input((16,)),
              keras.layers.Dense(32, activation="relu")]
    layers += list(extra or [])
    layers.append(keras.layers.Dense(4))
    model = keras.Sequential(layers)
    if seed is not None:
        rng = np.random.default_rng(seed)
        model.set_weights([(rng.normal(size=w.shape) * 0.3).astype(w.dtype)
                           for w in model.get_weights()])
    return model


_WINDOW = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
               learning_rate=0.1, num_workers=4, batch_size=8,
               communication_window=2, num_epoch=1)


# -- the cases, run inside the subprocesses -----------------------------------


def _torch_adag_window():
    import keras

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.trainers import ADAG

    x, y = _blobs(64)
    model = _mlp(keras, seed=0)
    out = ADAG(model, device="cpu", **_WINDOW).train(
        Dataset.from_arrays(x, y))
    assert out is model
    return [w.tolist() for w in model.get_weights()]


def _jax_adag_window():
    import keras

    from distkeras_tpu import ADAG
    from distkeras_tpu.data import Dataset

    x, y = _blobs(64)
    model = _mlp(keras, seed=0)
    out = ADAG(model, **_WINDOW).train(Dataset.from_arrays(x, y))
    assert out is model
    return [w.tolist() for w in model.get_weights()]


_MESH = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
             learning_rate=0.1, batch_size=8, num_epoch=1,
             mesh_shape={"dp": 1}, input_mode="stream")


def _torch_mesh_trainer():
    import keras

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.trainers import MeshTrainer

    x, y = _blobs(64)
    model = _mlp(keras, seed=0)
    t = MeshTrainer(model, device="cpu", **_MESH)
    try:
        out = t.train(Dataset.from_arrays(x, y))
    finally:
        t.close()
    assert out is model
    return [w.tolist() for w in model.get_weights()]


def _jax_mesh_trainer():
    import keras

    from distkeras_tpu import MeshTrainer
    from distkeras_tpu.data import Dataset

    x, y = _blobs(64)
    model = _mlp(keras, seed=0)
    out = MeshTrainer(model, **_MESH).train(Dataset.from_arrays(x, y))
    assert out is model
    return [w.tolist() for w in model.get_weights()]


def _torch_serde_roundtrip():
    import keras

    from distkeras_tpu_torch.utils import (
        deserialize_keras_model,
        serialize_keras_model,
    )

    model = _mlp(keras, seed=4)
    payload = serialize_keras_model(model)
    clone = deserialize_keras_model(payload)
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    return float(np.max(np.abs(model.predict(x, verbose=0)
                               - clone.predict(x, verbose=0))))


def _torch_trained_serde():
    import keras

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.trainers import ADAG
    from distkeras_tpu_torch.utils import (
        deserialize_keras_model,
        serialize_keras_model,
    )

    x, y = _blobs(1024)
    model = _mlp(keras)
    before = [np.copy(w) for w in model.get_weights()]
    t = ADAG(model, loss="sparse_softmax_cross_entropy",
             worker_optimizer="sgd", learning_rate=0.1, num_workers=4,
             batch_size=32, communication_window=2, num_epoch=2,
             device="cpu")
    t.train(Dataset.from_arrays(x, y))
    clone = deserialize_keras_model(serialize_keras_model(model))
    xs = x[:64]
    moved = any(not np.allclose(a, b)
                for a, b in zip(before, model.get_weights()))
    return {"moved": moved,
            "final_loss": float(np.mean(t.history.losses()[-3:])),
            "serde_diff": float(np.max(np.abs(
                model.predict(xs, verbose=0) - clone.predict(xs,
                                                             verbose=0))))}


def _train_stateful(kind, backend):
    """The JAX tests' BatchNorm and Dropout models through ADAG on one
    backend: returns what the tests check."""
    import keras

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.model import from_keras
    from distkeras_tpu_torch.trainers import ADAG

    extra = ([keras.layers.BatchNormalization()] if kind == "batchnorm"
             else [keras.layers.Dropout(0.5)])
    model = _mlp(keras, extra)
    rec = {}
    if kind == "dropout":
        import torch

        spec = from_keras(model)
        params, state = spec.init(0)
        xs = torch.as_tensor(np.random.default_rng(1).normal(
            size=(8, 16)).astype(np.float32))
        o1, s1 = spec.apply(params, state, xs, training=True)
        o2, _ = spec.apply(params, s1, xs, training=True)
        e1, _ = spec.apply(params, state, xs, training=False)
        e2, _ = spec.apply(params, state, xs, training=False)
        rec["train_stochastic"] = not torch.allclose(o1, o2)
        rec["infer_deterministic"] = bool(torch.equal(e1, e2))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    t = ADAG(model, loss="sparse_softmax_cross_entropy",
             worker_optimizer="adam", learning_rate=5e-3, num_workers=4,
             batch_size=16, communication_window=2, num_epoch=8,
             backend=backend, device="cpu")
    rec["returned_model"] = t.train(Dataset({"features": x, "label": y}),
                                    shuffle=True) is model
    if kind == "batchnorm":
        bn = model.layers[1]
        rec["mean_moved"] = float(np.max(np.abs(np.asarray(
            bn.moving_mean))))
        rec["var_moved"] = float(np.max(np.abs(np.asarray(
            bn.moving_variance) - 1.0)))
    rec["accuracy"] = float(np.mean(np.argmax(
        model.predict(x, verbose=0), -1) == y))
    return rec


def _torch_predictor():
    import keras

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.predictors import ModelPredictor

    model = _mlp(keras, seed=2)
    x, y = _blobs(100)
    got = ModelPredictor(model, batch_size=32, device="cpu").predict(
        Dataset.from_arrays(x, y))["prediction"]
    return float(np.max(np.abs(got - model.predict(x, verbose=0))))


def _torch_unbuilt_refused():
    import keras

    from distkeras_tpu_torch.model import from_keras

    try:
        from_keras(keras.Sequential([keras.layers.Dense(4)]))
    except ValueError as e:
        return str(e)
    return None


def _jax_backend_refused():
    """A Keras model on the jax backend, handed to the port."""
    import keras

    from distkeras_tpu_torch.model import from_keras
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.trainers import ADAG

    model = _mlp(keras)
    out = []
    for make in (lambda: from_keras(model),
                 lambda: ADAG(model, device="cpu"),
                 lambda: ModelPredictor(model, device="cpu")):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


_CASES = {
    "torch": {
        "adag_window": _torch_adag_window,
        "mesh_trainer": _torch_mesh_trainer,
        "serde_roundtrip": _torch_serde_roundtrip,
        "trained_serde": _torch_trained_serde,
        "batchnorm_collective": lambda: _train_stateful("batchnorm",
                                                        "collective"),
        "batchnorm_ps": lambda: _train_stateful("batchnorm", "ps"),
        "dropout_collective": lambda: _train_stateful("dropout",
                                                      "collective"),
        "dropout_ps": lambda: _train_stateful("dropout", "ps"),
        "predictor": _torch_predictor,
        "unbuilt": _torch_unbuilt_refused,
    },
    "jax": {
        "adag_window": _jax_adag_window,
        "mesh_trainer": _jax_mesh_trainer,
        "refused": _jax_backend_refused,
    },
}


def _run_cases(backend: str) -> None:
    """The subprocess's entry: every case of ``backend``, each result or
    its error on one JSON line."""
    if backend == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    import keras

    assert keras.backend.backend() == backend
    out = {}
    for name, case in _CASES[backend].items():
        try:
            out[name] = {"ok": case()}
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    print(_MARK + json.dumps(out), flush=True)


def _subprocess_env(backend: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), KERAS_BACKEND=backend,
               OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               TF_CPP_MIN_LOG_LEVEL="3",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return env


@pytest.fixture(scope="module")
def results():
    procs = {b: subprocess.Popen(
        [sys.executable, "-c",
         f"from tests.test_torch_keras import _run_cases; "
         f"_run_cases({b!r})"],
        cwd=REPO, env=_subprocess_env(b), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for b in _CASES}
    out = {}
    for b, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        line = next((ln for ln in stdout.splitlines()
                     if ln.startswith(_MARK)), None)
        assert p.returncode == 0 and line, stderr[-3000:]
        out[b] = json.loads(line[len(_MARK):])
    return out


def _ok(results, backend, name):
    rec = results[backend][name]
    assert "error" not in rec, rec.get("error")
    return rec["ok"]


# -- the tests ----------------------------------------------------------------


def test_keras_adag_window_matches_the_jax_package(results):
    """One unshuffled ADAG window (4 workers, window 2, batch 8, SGD) of
    the same Keras MLP in each package: every leaf within 1e-5 of its
    largest magnitude, and the window moved the weights."""
    tw = [np.asarray(w, np.float32) for w in
          _ok(results, "torch", "adag_window")]
    jw = [np.asarray(w, np.float32) for w in
          _ok(results, "jax", "adag_window")]
    init = [np.asarray(w) for w in _mlp_init_weights()]
    assert len(tw) == len(jw) == 4
    for t, j, i in zip(tw, jw, init):
        assert t.shape == j.shape
        assert np.max(np.abs(t - j)) <= 1e-5 * np.max(np.abs(j))
    assert any(np.max(np.abs(j - i)) > 1e-3 for j, i in zip(jw, init))


def test_keras_mesh_trainer_matches_the_jax_package(results):
    """``MeshTrainer`` on a mesh of one rank trains the live Keras model
    in place (8 unshuffled SGD steps of batch 8), equal to the JAX
    package's within 1e-5 of each leaf's largest magnitude."""
    tw = [np.asarray(w, np.float32) for w in
          _ok(results, "torch", "mesh_trainer")]
    jw = [np.asarray(w, np.float32) for w in
          _ok(results, "jax", "mesh_trainer")]
    init = [np.asarray(w) for w in _mlp_init_weights()]
    for t, j in zip(tw, jw):
        assert np.max(np.abs(t - j)) <= 1e-5 * np.max(np.abs(j))
    assert any(np.max(np.abs(j - i)) > 1e-3 for j, i in zip(jw, init))


def _mlp_init_weights():
    """The numpy-seeded starting weights of :func:`_mlp` (seed 0)."""
    shapes = [(16, 32), (32,), (32, 4), (4,)]
    rng = np.random.default_rng(0)
    return [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]


def test_serialize_keras_model_roundtrip(results):
    """``test_keras_frontend.py:64``."""
    assert _ok(results, "torch", "serde_roundtrip") <= 1e-5


def test_trained_keras_model_survives_serde(results):
    """``test_keras_frontend.py:74``: ADAG trains the live model in place
    and the trained model survives serde."""
    rec = _ok(results, "torch", "trained_serde")
    assert rec["moved"] and rec["final_loss"] < 0.5, rec
    assert rec["serde_diff"] <= 1e-5, rec


@pytest.mark.parametrize("backend", ["collective", "ps"])
def test_keras_batchnorm_model_trains_and_stats_move(results, backend):
    """``test_keras_frontend.py:99``: BatchNorm's moving statistics ride
    the state and are written back into the live model."""
    rec = _ok(results, "torch", f"batchnorm_{backend}")
    assert rec["returned_model"], rec
    assert rec["mean_moved"] > 1e-3 and rec["var_moved"] > 1e-3, rec
    assert rec["accuracy"] > 0.7, rec


@pytest.mark.parametrize("backend", ["collective", "ps"])
def test_keras_dropout_trains_and_infers_deterministically(results,
                                                          backend):
    """``test_keras_frontend.py:130``: Dropout is active in training (each
    call draws anew) and off at inference, and the model trains."""
    rec = _ok(results, "torch", f"dropout_{backend}")
    assert rec["train_stochastic"] and rec["infer_deterministic"], rec
    assert rec["returned_model"] and rec["accuracy"] > 0.7, rec


def test_keras_model_predictor(results):
    """``ModelPredictor`` takes a Keras model and predicts what
    ``model.predict`` does."""
    assert _ok(results, "torch", "predictor") <= 1e-5


def test_keras_refusals(results):
    """A jax-backend Keras model is refused by ``from_keras``, the
    trainers and ``ModelPredictor`` with the torch-backend message, and an
    unbuilt model is refused."""
    for msg in _ok(results, "jax", "refused"):
        assert msg and "'jax' backend" in msg and "KERAS_BACKEND=torch" \
            in msg, msg
    msg = _ok(results, "torch", "unbuilt")
    assert msg and "must be built" in msg


def test_mnist_twin_keras_frontend():
    """The MNIST twin with ``--frontend keras`` at a small size on the
    CPU, to the JAX example's gate (test accuracy > 0.8)."""
    proc = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.examples.mnist",
         "--device", "cpu", "--model", "mlp", "--rows", "2048",
         "--epochs", "1", "--batch-size", "32", "--frontend", "keras"],
        cwd=REPO, env=_subprocess_env("torch"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    acc = float(proc.stdout.rsplit("test accuracy:", 1)[1].strip())
    assert acc > 0.8, proc.stdout
