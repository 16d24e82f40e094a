"""The paper's user surface on the port (distkeras_tpu_torch/{transformers,
evaluators,predictors,utils}.py, ``get_merge_rule``, the trainers'
``validation_data`` and ``profile_dir``) held against the JAX package on
the same numpy inputs.

Tolerances: transformers are the same numpy operations, so columns are
equal (0); evaluators within 1e-6; predictors on f32 models with the same
weights (``convert.tensors_from_jax``) within 1e-5 absolute; validation
scores of the same W=1 unshuffled run within 1e-5 relative.
"""

import ast
import dataclasses
import functools
import os
import pathlib

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
    """``mesh=`` is taken (A12.2) and wants a port ``Mesh``
    (``tests/test_torch_dp_mesh.py`` runs it over ranks); ``quantize=True``
    serves the Dense layers in int8 and tracks the float predictor (argmax
    equal, logits within the int8 weights' error on this f32 MLP)."""
    spec = torch_mlp(input_shape=(4,), hidden=(4,), num_classes=2)
    params, _ = spec.init(0)
    with pytest.raises(TypeError, match="Mesh"):
        tpred.ModelPredictor(spec, params, mesh=object(), device="cpu")
    wide = torch_mlp(input_shape=(12,), hidden=(32, 16), num_classes=5,
                     dtype=torch.float32)
    wp, _ = wide.init(0)
    ds = tdata.Dataset({"features": np.random.default_rng(1).uniform(
        0, 1, (40, 12)).astype(np.float32)})
    ref = tpred.ModelPredictor(wide, wp, {}, batch_size=16,
                               device="cpu").predict(ds)["prediction"]
    q = tpred.ModelPredictor(wide, wp, {}, batch_size=16, quantize=True,
                             device="cpu")
    assert q.spec.name == "mlp_int8"
    assert q.params["Dense_0.kernel_q"].dtype == torch.int8
    got = q.predict(ds)["prediction"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=0.02 * np.abs(ref).max())
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
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


def test_the_package_exports_the_jax_packages_trainers():
    """``distkeras_tpu_torch`` exports every trainer class the JAX package
    exports, ``MeshTrainer`` included, each the class of ``trainers``
    (imported on first use)."""
    import distkeras_tpu
    import distkeras_tpu_torch

    names = {n for n in distkeras_tpu.__all__
             if isinstance(getattr(distkeras_tpu, n), type)
             and issubclass(getattr(distkeras_tpu, n),
                            distkeras_tpu.Trainer)}
    assert "MeshTrainer" in names
    assert names <= set(distkeras_tpu_torch.__all__)
    for n in names:
        assert getattr(distkeras_tpu_torch, n) is getattr(trainers, n)
    with pytest.raises(AttributeError):
        distkeras_tpu_torch.NoSuchTrainer


#: public module-level names of ``distkeras_tpu/**.py`` the port keeps no
#: definition of under the same module, each with its reason
_SURFACE_ALLOWED = {
    # JAX-only: flax and jax.sharding have no counterpart in torch
    "model.py": {"from_flax": "builds a ModelSpec from a flax module"},
    "parameter_servers.py": {
        "jax_tree_copy": "copies a jax pytree to host numpy"},
    "parallel/mesh.py": {
        "worker_sharding": "a jax.sharding.NamedSharding over the mesh",
        "replicated_sharding": "a jax.sharding.NamedSharding over the mesh"},
    "parallel/tensor.py": {
        "batch_sharding": "a jax.sharding.NamedSharding for batches"},
    "utils.py": {
        "enable_compilation_cache": "XLA's persistent compilation cache",
        # pytree helpers: the port's trees are dicts of tensors walked by
        # utils.tree_map / host_tree_map
        **{f"tree_{n}": "a jax pytree helper" for n in (
            "add", "sub", "scale", "stack", "unstack", "zeros_like",
            "count_params", "size_bytes", "broadcast_to_workers")}},
    "ops/pallas_kernels.py": {
        "FusedAdamState": "the optax state tuple of the fused Adam"},
    # names that live in another port module
    "models/lm.py": {"QDense": "is ops/quant.QDense (imported there)"},
    "parallel/sequence.py": {
        "attention_reference": "is in ops/flash_attention"},
}


def _defined_names(path) -> set:
    import ast

    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def test_every_jax_module_name_has_a_port_counterpart():
    """Queue A is closed: read with ``ast`` (no module is imported), every
    public module-level function and class of ``distkeras_tpu/**.py`` is
    defined under the same name in the port's module of the same path,
    apart from ``_SURFACE_ALLOWED``; and every allowed name is still
    missing (a stale entry fails)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    jroot, troot = root / "distkeras_tpu", root / "distkeras_tpu_torch"
    missing = {}
    for jpath in sorted(jroot.rglob("*.py")):
        rel = jpath.relative_to(jroot).as_posix()
        tpath = troot / rel
        assert tpath.exists(), f"no port module for {rel}"
        gone = _defined_names(jpath) - _defined_names(tpath)
        if gone:
            missing[rel] = gone
    assert missing == {k: set(v) for k, v in _SURFACE_ALLOWED.items()}


def test_next_token_dataset_matches_the_jax_package():
    from distkeras_tpu.models import next_token_dataset as jntd
    from distkeras_tpu_torch.models import next_token_dataset as tntd

    rows = np.random.default_rng(3).integers(0, 50, size=(6, 9))
    j, t = jntd(rows), tntd(rows)
    assert isinstance(t, tdata.Dataset) and len(t) == len(j) == 6
    for col in ("features", "label"):
        np.testing.assert_array_equal(t[col], np.asarray(j[col]))
        assert t[col].dtype == np.int32 and t[col].shape == (6, 8)
    np.testing.assert_array_equal(t["label"][:, :-1], t["features"][:, 1:])


# -- the surface at the method, keyword and __all__ level ---------------------
#
# Read with ``ast`` like the module-level check above: no module is
# imported. Each check is one case a JAX module; each has an allowlist of
# deliberate differences with their reasons, and an entry that is no longer
# a difference fails its case.

_FLAX_SETUP = "flax's submodule hook; a torch module builds its layers in " \
    "__init__"
_MODULE_NOT_PARAMS = "the port takes a torch module or a state dict, not a " \
    "params pytree (ROADMAP.md, deliberate differences)"
_PALLAS_INTERPRET = "Pallas interpret mode; a port wrapper runs its plain " \
    "version on a CPU tensor"

#: ``{module: {Class: {method: reason}}}``: public methods of a JAX class
#: that its port counterpart neither defines nor inherits
_METHODS_ALLOWED = {
    "models/lm.py": {"DecoderBlock": {"setup": _FLAX_SETUP},
                     "TransformerLM": {"setup": _FLAX_SETUP}},
    "models/transformer.py": {
        "TransformerClassifier": {"setup": _FLAX_SETUP}},
}

#: ``{module: {callable: {parameter: reason}}}``: parameter names of a
#: public JAX function or method (``Class.method``) that the port's
#: counterpart accepts neither by name nor through ``**kw``
_PARAMS_ALLOWED = {
    "models/lm.py": {
        "generate": {"params": _MODULE_NOT_PARAMS},
        "beam_search": {"params": _MODULE_NOT_PARAMS},
        "quantize_lm": {"params": _MODULE_NOT_PARAMS},
        "speculative_generate": {"target_params": _MODULE_NOT_PARAMS,
                                 "draft_params": _MODULE_NOT_PARAMS},
        "TransformerLM.hidden": {
            "training": "flax's train flag; a torch module's mode is "
                        "train()/eval(), and the LM has no dropout"},
        **{"transformer_lm": {k: "the port's transformer_lm returns the "
                                 "served module; the training spec's knobs "
                                 "are transformer_lm_spec's"
                              for k in ("fused_ce", "ce_chunk", "remat")}},
    },
    "models/transformer.py": {"attention_sublayer": {
        **{k: "flax builds the layers in the call from dim and dtype; the "
              "port passes the block's layers (ln_attn, qkv, attn_out)"
           for k in ("dim", "dtype")},
        **{k: "the in-shard_map ring of attn_impl='ring'; the port's ring "
              "is sequence_parallel_transformer_forward's"
           for k in ("sp_axis", "sp_size")}}},
    "predictors.py": {"GeneratorPredictor.__init__": {
        "params": _MODULE_NOT_PARAMS}},
    "serving/scheduler.py": {
        "GenerationEngine.__init__": {"params": _MODULE_NOT_PARAMS,
                                      "draft_params": _MODULE_NOT_PARAMS},
        "GenerationEngine.swap_params": {
            "params": "a state dict, named weights",
            "draft_params": "a state dict, named draft_weights"}},
    "serving/paged_cache.py": {"sample_rows": {
        "keys": "jax PRNG keys; the port draws from a torch.Generator "
                "seeded per row (seeds, positions)"}},
    "ops/flash_attention.py": {"flash_attention": {
        "interpret": _PALLAS_INTERPRET}},
    "ops/pallas_kernels.py": {"fused_adam": {"interpret": _PALLAS_INTERPRET}},
    "ops/recurrent.py": {"lstm_scan": {"interpret": _PALLAS_INTERPRET}},
    "ops/quant.py": {"q_matmul": {
        "interpret": _PALLAS_INTERPRET,
        "impl": "picks the Pallas or the XLA path; the port's plan "
                "(plan_q_matmul) picks the kernel's"}},
    "parallel/mesh.py": {
        "get_mesh": {"devices": "a list of jax devices; a port rank is one "
                                "process and one card"},
        "put_global": {"sharding": "a GSPMD sharding; the port's ranks hold "
                                   "their own parts"}},
    "parallel/tensor.py": {"get_mesh_nd": {
        "devices": "a list of jax devices; a port rank is one process and "
                   "one card"}},
    "parallel/strategies.py": {
        **{f"{s}_strategy": {"dp_axis": "the port's engine splits the batch "
                                        "over dp itself (dp x sp, pp x dp)"}
           for s in ("pipeline", "sequence")}},
    "workers.py": {"AsyncWorker.__init__": {
        "optimizer": "the optimizer is held by window_fn"}},
    "native/__init__.py": {"load_dkps": {
        "required": "the port raises and never returns None, so a missing "
                    "build cannot pass unseen"}},
}

#: ``{subpackage: {name: reason}}``: names of a JAX package's ``__all__``
#: that the port's package does not bind
_EXPORTS_ALLOWED: dict = {}

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_JROOT, _TROOT = _ROOT / "distkeras_tpu", _ROOT / "distkeras_tpu_torch"
_JAX_MODULES = sorted(p.relative_to(_JROOT).as_posix()
                      for p in _JROOT.rglob("*.py"))
_FN = (ast.FunctionDef, ast.AsyncFunctionDef)


@functools.lru_cache(maxsize=None)
def _ast(root, rel):
    return ast.parse((root / rel).read_text())


def _top(tree, kinds):
    return {n.name: n for n in tree.body if isinstance(n, kinds)}


def _port_module_of(rel, name):
    """Where the port's module ``rel`` takes ``name`` from: itself, or the
    port module a ``from distkeras_tpu_torch... import`` names."""
    for n in _ast(_TROOT, rel).body:
        if isinstance(n, ast.ImportFrom) and n.module and \
                n.module.startswith("distkeras_tpu_torch"):
            for a in n.names:
                if (a.asname or a.name) == name:
                    sub = n.module.split(".")[1:]
                    path = "/".join(sub)
                    if (_TROOT / f"{path}.py").exists():
                        return f"{path}.py", a.name
                    return f"{path}/__init__.py", a.name
    return rel, name


def _port_class_methods(rel, name, depth=0):
    """The methods of the port's class ``name`` in ``rel`` by name, its
    bases' (resolved through the port's own modules) beneath its own."""
    rel, name = _port_module_of(rel, name)
    cls = _top(_ast(_TROOT, rel), ast.ClassDef).get(name)
    if cls is None or depth > 8:
        return {}
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            out.update(_port_class_methods(rel, base.id, depth + 1))
    out.update({n.name: n for n in cls.body if isinstance(n, _FN)})
    for n in cls.body:   # `name = other_method` aliases
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and isinstance(n.value, ast.Name) \
                        and n.value.id in out:
                    out[t.id] = out[n.value.id]
    return out


def _jax_public_methods(cls):
    return {n.name: n for n in cls.body if isinstance(n, _FN)
            and (not n.name.startswith("_") or n.name == "__init__")}


def _accepts(fn):
    """The parameter names ``fn`` takes by name (``self``/``cls`` aside),
    and whether it takes ``**kw``."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names, a.kwarg is not None


def _jax_public_classes(rel):
    port = _top(_ast(_TROOT, rel), ast.ClassDef)
    return {n: c for n, c in _top(_ast(_JROOT, rel), ast.ClassDef).items()
            if not n.startswith("_") and n in port}


@pytest.mark.parametrize("rel", _JAX_MODULES)
def test_every_jax_method_has_a_port_counterpart(rel):
    """Every public method (``__init__`` included) of every public JAX
    class in ``rel`` is defined on, or inherited by, the port's class of
    the same name in the port's module of the same path, apart from
    ``_METHODS_ALLOWED``, whose entries must still be missing."""
    missing = {}
    for name, cls in _jax_public_classes(rel).items():
        port = _port_class_methods(rel, name)
        gone = {m for m in _jax_public_methods(cls) if m not in port}
        if gone:
            missing[name] = gone
    allowed = {c: set(ms) for c, ms in _METHODS_ALLOWED.get(rel, {}).items()}
    assert missing == allowed


def _jax_callables(rel):
    """``{qualname: (jax def, port def or None)}`` for the public functions
    of ``rel`` and the public methods of its public classes; a JAX
    function that the port defines as a class meets that class's
    ``__init__``."""
    jtree, ttree = _ast(_JROOT, rel), _ast(_TROOT, rel)
    out = {}
    tfns, tcls = _top(ttree, _FN), _top(ttree, ast.ClassDef)
    for name, fn in _top(jtree, _FN).items():
        if name.startswith("_"):
            continue
        if name in tfns:
            out[name] = (fn, tfns[name])
        elif name in tcls:
            out[name] = (fn, _port_class_methods(rel, name).get("__init__"))
    for cname, cls in _jax_public_classes(rel).items():
        port = _port_class_methods(rel, cname)
        for m, fn in _jax_public_methods(cls).items():
            if m in port:
                out[f"{cname}.{m}"] = (fn, port[m])
    return out


@pytest.mark.parametrize("rel", _JAX_MODULES)
def test_every_jax_keyword_is_accepted_by_the_port(rel):
    """Every parameter name of every public JAX function and method in
    ``rel`` is accepted by the port's counterpart, by name or through
    ``**kw``, apart from ``_PARAMS_ALLOWED``, whose entries must still be
    refused."""
    refused = {}
    for qual, (jfn, tfn) in _jax_callables(rel).items():
        if tfn is None:
            continue
        tnames, tkw = _accepts(tfn)
        gone = set() if tkw else set(_accepts(jfn)[0]) - set(tnames)
        if gone:
            refused[qual] = gone
    allowed = {q: set(ps) for q, ps in _PARAMS_ALLOWED.get(rel, {}).items()}
    assert refused == allowed


def _module_all(tree):
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            return n.value
    return None


def _port_exports(rel):
    """Names the port's package ``rel`` binds at module level (imports,
    definitions, assignments), plus those its module ``__getattr__``
    serves: string constants in its body and in the module-level
    assignments it reads."""
    tree = _ast(_TROOT, rel)
    bound, assigned = set(), {}
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in n.names}
        elif isinstance(n, (*_FN, ast.ClassDef)):
            bound.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
                    assigned[t.id] = n.value
    lazy = _top(tree, _FN).get("__getattr__")
    if lazy is not None:
        reads = {x.id for x in ast.walk(lazy) if isinstance(x, ast.Name)}
        for node in [lazy] + [v for k, v in assigned.items() if k in reads]:
            bound |= {c.value for c in ast.walk(node)
                      if isinstance(c, ast.Constant)
                      and isinstance(c.value, str)}
    return bound


_JAX_PACKAGES = [r for r in _JAX_MODULES if r.endswith("__init__.py")
                 and _module_all(_ast(_JROOT, r)) is not None]


@pytest.mark.parametrize("rel", _JAX_PACKAGES)
def test_every_jax_export_is_importable_from_the_port(rel):
    """Every name in the ``__all__`` of a JAX package (the top level and
    each subpackage) is bound by the port's package of the same path, apart
    from ``_EXPORTS_ALLOWED``, whose entries must still be unbound."""
    names = ast.literal_eval(_module_all(_ast(_JROOT, rel)))
    missing = set(names) - _port_exports(rel)
    assert missing == set(_EXPORTS_ALLOWED.get(rel, {}))


def test_every_surface_allowlist_entry_names_a_jax_definition():
    """An allowlist key that names no JAX module, class or callable (a
    rename, a typo) would pass unseen; every entry carries a reason."""
    for rel, classes in _METHODS_ALLOWED.items():
        jcls = _jax_public_classes(rel)
        for c, ms in classes.items():
            assert c in jcls, (rel, c)
            assert all(isinstance(r, str) and r for r in ms.values())
    for rel, quals in _PARAMS_ALLOWED.items():
        calls = _jax_callables(rel)
        for q, ps in quals.items():
            assert q in calls, (rel, q)
            assert set(ps) <= set(_accepts(calls[q][0])[0]), (rel, q)
            assert all(isinstance(r, str) and r for r in ps.values())
    for rel, names in _EXPORTS_ALLOWED.items():
        assert rel in _JAX_PACKAGES, rel
        assert all(isinstance(r, str) and r for r in names.values())
