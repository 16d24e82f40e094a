"""The paper's user surface on the port (distkeras_tpu_torch/{transformers,
evaluators,predictors,utils}.py, ``get_merge_rule``, the trainers'
``validation_data`` and ``profile_dir``) held against the JAX package on
the same numpy inputs.

Tolerances: transformers are the same numpy operations, so columns are
equal (0); evaluators within 1e-6; predictors on f32 models with the same
weights (``convert.tensors_from_jax``) within 1e-5 absolute; validation
scores of the same W=1 unshuffled run within 1e-5 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.data as jdata
from distkeras_tpu import ADAG as JADAG
from distkeras_tpu import evaluators as jev
from distkeras_tpu import predictors as jpred
from distkeras_tpu import transformers as jtf
from distkeras_tpu import utils as jutils
from distkeras_tpu.models import lenet as jax_lenet
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import data as tdata
from distkeras_tpu_torch import evaluators as tev
from distkeras_tpu_torch import predictors as tpred
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch import transformers as ttf
from distkeras_tpu_torch import utils as tutils
from distkeras_tpu_torch.convert import tensors_from_jax
from distkeras_tpu_torch.models import lenet as torch_lenet
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.parallel import merge_rules as tr


def _cols(seed=0, n=40):
    rng = np.random.default_rng(seed)
    seqs = np.empty(n, dtype=object)
    for i in range(n):
        seqs[i] = rng.integers(1, 50, int(rng.integers(1, 12)))
    sparse = np.empty(n, dtype=object)
    for i in range(n):
        idx = rng.choice(10, 3, replace=False)
        sparse[i] = (idx, rng.normal(size=3).astype(np.float32))
    return {
        "features": rng.uniform(0, 255, size=(n, 12)).astype(np.float32),
        "label": rng.integers(0, 5, n).astype(np.int32),
        "prediction": rng.normal(size=(n, 5)).astype(np.float32),
        "score": rng.normal(size=n).astype(np.float32),
        "binary": rng.integers(0, 2, n).astype(np.int32),
        "sequence": seqs,
        "sparse": sparse,
    }


def _transformer_pairs():
    mk = lambda mod: [
        mod.LabelIndexTransformer(5),
        mod.LabelIndexTransformer(input_col="score", output_col="idx1"),
        mod.OneHotTransformer(5),
        mod.MinMaxTransformer(0.0, 1.0, 0.0, 255.0),
        mod.StandardScaleTransformer(output_col="std"),
        mod.ReshapeTransformer("features", "img", (3, 4, 1)),
        mod.DenseTransformer("sparse", "dense", dim=10),
        mod.DenseTransformer("features", "features_f32"),
        mod.SequencePadTransformer(8),
    ]
    return list(zip(mk(jtf), mk(ttf)))


@pytest.mark.parametrize("k", range(9))
def test_each_transformer_matches_the_jax_package(k):
    jt, tt = _transformer_pairs()[k]
    cols = _cols()
    jout, tout = jt.transform(jdata.Dataset(cols)), \
        tt.transform(tdata.Dataset(cols))
    assert jout.columns == tout.columns
    for c in jout.columns:
        if jout[c].dtype == object:
            continue
        assert jout[c].dtype == tout[c].dtype, c
        np.testing.assert_array_equal(tout[c], jout[c])


def test_transformer_pipeline_matches_the_jax_package():
    cols = _cols(seed=1)
    pairs = _transformer_pairs()
    jp = jtf.TransformerPipeline([j for j, _ in pairs])
    tp = ttf.TransformerPipeline([t for _, t in pairs])
    jout, tout = jp(jdata.Dataset(cols)), tp(tdata.Dataset(cols))
    for c in jout.columns:
        if jout[c].dtype != object:
            np.testing.assert_array_equal(tout[c], jout[c])
    with pytest.raises(ValueError, match="dim required"):
        ttf.DenseTransformer("sparse").transform(tdata.Dataset(cols))


def _evaluator_pairs():
    return [
        (jev.AccuracyEvaluator(), tev.AccuracyEvaluator()),
        (jev.LossEvaluator("sparse_softmax_cross_entropy"),
         tev.LossEvaluator("sparse_softmax_cross_entropy")),
        (jev.LossEvaluator("mse", prediction_col="score",
                           label_col="binary"),
         tev.LossEvaluator("mse", prediction_col="score",
                           label_col="binary")),
        (jev.FScoreEvaluator(average="macro"),
         tev.FScoreEvaluator(average="macro")),
        (jev.FScoreEvaluator("precision", prediction_col="binary"),
         tev.FScoreEvaluator("precision", prediction_col="binary")),
        (jev.AUCEvaluator(prediction_col="score", label_col="binary"),
         tev.AUCEvaluator(prediction_col="score", label_col="binary")),
        (jev.AUCEvaluator(pos_label=2), tev.AUCEvaluator(pos_label=2)),
    ]


@pytest.mark.parametrize("k", range(7))
def test_each_evaluator_matches_the_jax_package(k):
    je, te = _evaluator_pairs()[k]
    cols = _cols(seed=2, n=200)
    got = te.evaluate(tdata.Dataset(cols))
    ref = je.evaluate(jdata.Dataset(cols))
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-6, (got, ref)


def _predictor_pair(kind):
    if kind == "mlp":
        jspec = jax_mlp(input_shape=(8, 8, 1), hidden=(32, 16),
                        dtype=jnp.float32)
        tspec = torch_mlp(input_shape=(8, 8, 1), hidden=(32, 16),
                          dtype=torch.float32)
        shape = (8, 8, 1)
    else:
        jspec, tspec = jax_lenet(dtype=jnp.float32), \
            torch_lenet(dtype=torch.float32)
        shape = (28, 28, 1)
    p, nt = jspec.init_np(0)
    return jspec, tspec, p, nt, tensors_from_jax(p, tspec.module), shape


@pytest.mark.parametrize("kind", ["mlp", "lenet"])
def test_predictors_match_the_jax_package(kind):
    jspec, tspec, p, nt, tp, shape = _predictor_pair(kind)
    rng = np.random.default_rng(3)
    cols = {"features": rng.uniform(0, 1, (45,) + shape).astype(np.float32)}
    jds, tds = jdata.Dataset(cols), tdata.Dataset(cols)
    ref = jpred.ModelPredictor(jspec, p, nt, batch_size=16).predict(jds)
    got = tpred.ModelPredictor(tspec, tp, {}, batch_size=16,
                               device="cpu").predict(tds)
    assert got["prediction"].shape == ref["prediction"].shape
    np.testing.assert_allclose(got["prediction"], ref["prediction"],
                               rtol=0, atol=1e-5)
    jli = jpred.LabelIndexPredictor(jspec, p, nt, batch_size=16).predict(jds)
    tli = tpred.LabelIndexPredictor(tspec, tp, {}, batch_size=16,
                                    device="cpu").predict(tds)
    assert tli["prediction"].dtype == np.int32
    np.testing.assert_array_equal(tli["prediction"], jli["prediction"])


def test_predictor_later_options_name_their_item():
    spec = torch_mlp(input_shape=(4,), hidden=(4,), num_classes=2)
    params, _ = spec.init(0)
    with pytest.raises(NotImplementedError, match="A12"):
        tpred.ModelPredictor(spec, params, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A11.5"):
        tpred.ModelPredictor(spec, params, quantize=True, device="cpu")
    with pytest.raises(TypeError, match="Keras 3 model or"):
        tpred.ModelPredictor(object(), params, device="cpu")
    with pytest.raises(ValueError, match="explicit params"):
        tpred.ModelPredictor(spec, device="cpu")
    pred = tpred.ModelPredictor(spec, params, device="cpu")
    params["Dense_0.weight"].zero_()     # the predictor holds its own copy
    assert pred.params["Dense_0.weight"].abs().sum() > 0


@pytest.mark.parametrize("name,kw", [
    ("adag", {}), ("DOWNPOUR", {}), ("aeasgd", {}), ("eamsgd",
                                                   {"rho": 2.0}),
    ("easgd", {"learning_rate": 0.1}), ("dynsgd", {})])
def test_get_merge_rule_matches_the_jax_package(name, kw):
    j, t = jr.get_merge_rule(name, **kw), tr.get_merge_rule(name, **kw)
    assert type(t).__name__ == type(j).__name__
    assert getattr(t, "alpha", None) == getattr(j, "alpha", None)
    assert t.resets_workers == j.resets_workers
    with pytest.raises(ValueError, match="unknown merge rule"):
        tr.get_merge_rule("sgd")


def test_worker_commit_matches_the_jax_package():
    rng = np.random.default_rng(6)
    w = {"a": rng.normal(size=(5, 3)).astype(np.float32)}
    c = {"a": rng.normal(size=(5, 3)).astype(np.float32)}
    ref = jr.ElasticAverageMerge(0.15).worker_commit(w, c)
    got = tr.ElasticAverageMerge(0.15).worker_commit(w, c)
    np.testing.assert_array_equal(got["a"], np.asarray(ref["a"]))


def _blobs(n, seed):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(0).normal(0, 3.0, (4, 16)) \
        .astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1.0, (n, 16)).astype(np.float32)
    return x, y


def test_validation_data_matches_the_jax_trainer():
    """W=1, unshuffled, the same initial weights: the per-epoch held-out
    loss and accuracy of the collective path are the JAX trainer's."""
    x, y = _blobs(256, 1)
    vx, vy = _blobs(70, 2)          # not a multiple of the batch: padding
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    tspec = torch_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                      dtype=torch.float32)
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=1, batch_size=16,
              communication_window=2, num_epoch=2)
    jt = JADAG(jspec, validation_data=jdata.Dataset.from_arrays(vx, vy), **kw)
    jt.train(jdata.Dataset.from_arrays(x, y))
    tt = trainers.ADAG(tspec, validation_data=(vx, vy), device="cpu", **kw)
    tt.train(tdata.Dataset.from_arrays(x, y))
    jrec = [r for r in jt.history if "val_loss" in r]
    trec = [r for r in tt.history if "val_loss" in r]
    assert [r["epoch"] for r in trec] == [0, 1] == [r["epoch"] for r in jrec]
    for a, b in zip(jrec, trec):
        np.testing.assert_allclose(b["val_loss"], a["val_loss"], rtol=1e-5)
        np.testing.assert_allclose(b["val_accuracy"], a["val_accuracy"],
                                   rtol=1e-6)
    assert tt.history.val_losses() == [r["val_loss"] for r in trec]


def test_validation_data_on_the_ps_backend_scores_once():
    x, y = _blobs(256, 1)
    vx, vy = _blobs(50, 2)
    spec = torch_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                     dtype=torch.float32)
    t = trainers.DynSGD(spec, loss="sparse_softmax_cross_entropy",
                        worker_optimizer="sgd", learning_rate=0.1,
                        num_workers=2, batch_size=16, communication_window=2,
                        num_epoch=2, backend="ps", device="cpu",
                        validation_data=(vx, vy))
    t.train(tdata.Dataset.from_arrays(x, y))
    recs = [r for r in t.history if "val_loss" in r]
    assert len(recs) == 1 and "epoch" not in recs[0]
    assert recs[0]["val_accuracy"] > 0.9
    with pytest.raises(ValueError, match="0 rows"):
        trainers.ADAG(spec, device="cpu", validation_data=(
            vx[:0], vy[:0])).train(tdata.Dataset.from_arrays(x, y))


def test_profile_dir_leaves_a_trace(tmp_path):
    x, y = _blobs(128, 1)
    spec = torch_mlp(input_shape=(16,), hidden=(8,), num_classes=4,
                     dtype=torch.float32)
    t = trainers.ADAG(spec, loss="sparse_softmax_cross_entropy",
                      num_workers=2, batch_size=16, communication_window=2,
                      device="cpu", profile_dir=str(tmp_path / "prof"))
    t.train(tdata.Dataset.from_arrays(x, y))
    assert t.profile_path_ is not None and os.path.getsize(t.profile_path_)
    assert os.path.dirname(t.profile_path_) == str(tmp_path / "prof")
    import json

    with open(t.profile_path_) as f:
        assert json.load(f)["traceEvents"]


# -- utils ------------------------------------------------------------------


def test_flatten_walks_leaves_in_jax_tree_order():
    tree = {"b": {"y": np.ones(2), "x": [np.zeros(1), (np.ones(3),)]},
            "a": np.arange(4), "c": None}
    leaves, st = tutils.flatten(tree)
    ref = jax.tree.leaves(tree)
    assert len(leaves) == len(ref)
    for a, b in zip(ref, leaves):
        np.testing.assert_array_equal(a, b)
    back = tutils.unflatten(st, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_serialize_weights_roundtrip():
    tree = {"Dense_0.weight": torch.randn(3, 4),
            "nested": {"b": np.arange(5, dtype=np.int32)}}
    back = tutils.deserialize_weights(tutils.serialize_weights(tree))
    np.testing.assert_array_equal(back["Dense_0.weight"],
                                  tree["Dense_0.weight"].numpy())
    np.testing.assert_array_equal(back["nested"]["b"], tree["nested"]["b"])
    assert back["nested"]["b"].dtype == np.int32


def test_uniform_weights_bounds_and_determinism():
    tree = {"w": torch.zeros(64, 32), "h": np.zeros((7,), np.float32)}
    a = tutils.uniform_weights(tree, (-0.2, 0.3), seed=4)
    b = tutils.uniform_weights(tree, (-0.2, 0.3), seed=4)
    c = tutils.uniform_weights(tree, (-0.2, 0.3), seed=5)
    assert isinstance(a["w"], torch.Tensor) and a["h"].dtype == np.float32
    assert float(a["w"].min()) >= -0.2 and float(a["w"].max()) < 0.3
    assert float(a["w"].std()) > 0.1
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    np.testing.assert_array_equal(a["h"], b["h"])


def test_row_helpers_match_the_jax_package():
    cols = {"x": np.arange(10, dtype=np.float32), "y": np.arange(10)}
    np.testing.assert_array_equal(tutils.shuffle(tdata.Dataset(cols))["x"],
                                  jutils.shuffle(jdata.Dataset(cols))["x"])
    assert tutils.new_dataframe_row({"a": 1}, "b", 2) == \
        jutils.new_dataframe_row({"a": 1}, "b", 2)
    np.testing.assert_array_equal(tutils.to_vector(3, 5),
                                  jutils.to_vector(3, 5))
    np.testing.assert_array_equal(
        tutils.to_dense_vector([1.0, 2.0], [4, 1], 6),
        jutils.to_dense_vector([1.0, 2.0], [4, 1], 6))
    np.testing.assert_array_equal(tutils.to_dense_vector([1, 2]),
                                  jutils.to_dense_vector([1, 2]))
    tree = {"a": torch.ones(2), "b": {"c": np.zeros(1)}}
    out = tutils.tree_to_numpy(tree)
    assert isinstance(out["a"], np.ndarray) and \
        isinstance(out["b"]["c"], np.ndarray)
