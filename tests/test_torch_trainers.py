"""The port's training path — data, datasets, merge rules, the local-SGD
engine and the trainers (distkeras_tpu_torch/{data,datasets,parallel,
trainers}.py) — held against the JAX package on the same numpy inputs and
the same initial weights (carried over by ``convert.tensors_from_jax``).

Tolerances: f32 on both sides, the same operations in another summation
order. One SGD window: centers and workers within 1e-6 absolute (the JAX
engine, ``__graft_entry__._one_window``, holds its own to 1e-3 on the CPU
mesh). DynSGD with fused Adam over two windows: 1e-5 absolute on the
center at lr 1e-3. Adam divides by sqrt(v): where a gradient is pure float
noise (|g| of order 1e-9 against eps 1e-8) the two sides can take
different updates of up to lr each step, so a run with such elements would
differ by up to 4·lr = 4e-3 there and fail 1e-5 loudly. Unused embedding
rows get exactly zero gradients on both sides (u = 0), and the gradients
that reach the rest are far above that noise, so the bound holds with a
margin (measured: 7e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu.data as jdata
import distkeras_tpu.datasets as jds
from distkeras_tpu import DynSGD as JDynSGD
from distkeras_tpu.models import lstm_classifier as jax_lstm
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.ops.losses import sparse_softmax_cross_entropy as jax_ce
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.parallel.local_sgd import LocalSGDEngine as JaxEngine
from distkeras_tpu.parallel.mesh import get_mesh
from distkeras_tpu_torch import data as tdata
from distkeras_tpu_torch import datasets as tds
from distkeras_tpu_torch import optim, trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.models import lstm_classifier as torch_lstm
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.ops.losses import (
    sparse_softmax_cross_entropy as torch_ce,
)
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

W, WIN, B = 4, 2, 8


def _mlp_pair():
    jspec = jax_mlp(hidden=(32, 16), dtype=jnp.float32)
    tspec = torch_mlp(hidden=(32, 16), dtype=torch.float32)
    p, nt = jspec.init_np(0)
    return jspec, tspec, p, nt, tensors_from_jax(p, tspec.module)


def _rules(name):
    """(JAX rule, port rule, JAX optimizer, port optimizer) per trainer."""
    sgd = (optax.sgd(0.1), optim.sgd(0.1))
    if name == "ADAG":
        return jr.ADAGMerge(), tr.ADAGMerge(), *sgd
    if name == "DOWNPOUR":
        return jr.DownpourMerge(), tr.DownpourMerge(), *sgd
    if name == "AEASGD":
        return (jr.ElasticAverageMerge(0.12), tr.ElasticAverageMerge(0.12),
                *sgd)
    if name == "EAMSGD":
        return (jr.ElasticAverageMerge(0.12), tr.ElasticAverageMerge(0.12),
                optax.sgd(0.1, momentum=0.9, nesterov=True),
                optim.sgd(0.1, momentum=0.9, nesterov=True))
    return jr.DynSGDMerge(), tr.DynSGDMerge(), *sgd


@pytest.mark.parametrize("name", ["ADAG", "DOWNPOUR", "AEASGD", "EAMSGD",
                                  "DynSGD"])
def test_one_window_matches_jax_engine(name):
    jspec, tspec, p, nt, tp = _mlp_pair()
    jrule, trule, jopt, topt = _rules(name)
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.2, size=(W, WIN, B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(W, WIN, B)).astype(np.int32)

    def jax_step(params, nt_, b):
        out, n = jspec.apply(params, nt_, b[0], training=True)
        return jax_ce(b[1], out), n

    def torch_step(params, nt_, b):
        out, n = tspec.apply(params, nt_, b[0], training=True)
        return torch_ce(b[1], out), n

    je = JaxEngine(jspec, jax_step, jopt, jrule, get_mesh(W), num_workers=W,
                   window=WIN)
    jstate, jloss = je.run_window(je.init_state(p, nt), (x, y))
    te = LocalSGDEngine(tspec, torch_step, topt, trule, device="cpu",
                        num_workers=W, window=WIN)
    tstate, tloss = te.run_window(te.init_state(tp, {}), (x, y))
    assert tstate.step == 1
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    center = params_to_jax(te.center_params(tstate), tspec.module)
    for a, b in zip(jax.tree.leaves(jstate.center), jax.tree.leaves(center)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)
    jw = jax.device_get(jstate.workers)
    for i in range(W):
        wi = params_to_jax({k: v[i] for k, v in tstate.workers.items()},
                           tspec.module)
        for a, b in zip(jax.tree.leaves(jw), jax.tree.leaves(wi)):
            np.testing.assert_allclose(b, np.asarray(a)[i], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["ADAG", "DOWNPOUR", "AEASGD", "DynSGD"])
def test_fold_on_host_trees_matches_jax(name):
    """The one-commit form the parameter-server backend folds with, on
    nested numpy trees: the same operators on the same values, exact."""
    jrule, trule, _, _ = _rules(name)
    rng = np.random.default_rng(8)
    center = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
              "wh": rng.normal(size=(4,)).astype(np.float32)}
    commit = jax.tree.map(lambda x: (x * 0.1).astype(np.float32), center)
    ref = jrule.fold(center, commit, num_workers=4, staleness=2)
    got = trule.fold(center, commit, num_workers=4, staleness=2)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(b, np.asarray(a))
    assert trule.resets_workers == jrule.resets_workers


def test_dynsgd_fused_adam_lstm_matches_jax_trainer():
    """The slice's main path at a small size: DynSGD + fused Adam on the
    LSTM classifier with (features, mask) columns, two windows."""
    n = W * WIN * B * 2
    kw = dict(vocab=1000, embed_dim=16, hidden_dim=32)
    jtrain, _ = jds.imdb(n_train=n, n_test=8, vocab=1000, maxlen=24)
    ttrain, _ = tds.imdb(n_train=n, n_test=8, vocab=1000, maxlen=24)
    jspec = jax_lstm(maxlen=24, dtype=jnp.float32, **kw)
    tspec = torch_lstm(dtype=torch.float32, **kw)
    p, _ = jspec.init_np(0)
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    common = dict(loss="sparse_softmax_cross_entropy",
                  worker_optimizer="fused_adam", learning_rate=1e-3,
                  features_col=["features", "mask"], num_workers=W,
                  batch_size=B, communication_window=WIN)
    jt = JDynSGD(jspec, **common)
    jcenter = jt.train(jtrain)
    tt = trainers.DynSGD(tspec, device="cpu", **common)
    tcenter = tt.train(ttrain)
    assert len(tt.history.losses()) == 2
    np.testing.assert_allclose(tt.history.losses(), jt.history.losses(),
                               rtol=1e-6)
    back = params_to_jax(tcenter, tspec.module)
    for a, b in zip(jax.tree.leaves(jcenter), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def _blobs(n=512, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, n).astype(np.int32)
    centers = rng.normal(0, 3, (4, 8)).astype(np.float32)
    x = centers[y] + rng.normal(0, 0.5, (n, 8)).astype(np.float32)
    return tdata.Dataset.from_arrays(x, y)


@pytest.mark.parametrize("cls", ["SingleTrainer", "ADAG", "DOWNPOUR",
                                 "AEASGD", "EAMSGD", "DynSGD"])
def test_every_trainer_learns_on_cpu(cls):
    ds = _blobs()
    spec = torch_mlp(input_shape=(8,), hidden=(16,), num_classes=4,
                     dtype=torch.float32)
    kw = dict(loss="sparse_softmax_cross_entropy", batch_size=16,
              num_epoch=3, device="cpu")
    if cls == "SingleTrainer":
        t = trainers.SingleTrainer(spec, worker_optimizer="adam",
                                   learning_rate=1e-2, **kw)
    else:
        lr = 0.01 if cls in ("AEASGD", "EAMSGD") else 1e-2
        t = getattr(trainers, cls)(spec, worker_optimizer="adam",
                                   learning_rate=lr, num_workers=4,
                                   communication_window=2, **kw)
    params = t.train(ds, shuffle=True)
    losses = t.history.losses()
    assert np.mean(losses[-3:]) < 0.5 * np.mean(losses[:3]), losses
    assert set(params) == {"Dense_0.weight", "Dense_0.bias",
                           "Dense_1.weight", "Dense_1.bias"}
    assert t.get_training_time() > 0


def test_adag_lenet_learns_synthetic_mnist():
    """The flagship (BASELINE config 2, LeNet under ADAG) through the
    stacked-worker vmap over convolutions, to the accuracy gate the JAX
    package's MNIST example is held to (> 0.8 on held-out rows)."""
    from distkeras_tpu_torch.models import lenet
    from distkeras_tpu_torch.ops.metrics import accuracy

    train, test = tds.mnist(n_train=2048, n_test=256)
    spec = lenet(dtype=torch.float32)
    t = trainers.ADAG(spec, loss="sparse_softmax_cross_entropy",
                      worker_optimizer="adam", learning_rate=1e-3,
                      num_workers=4, batch_size=32, communication_window=2,
                      num_epoch=2, device="cpu")
    params = t.train(train, shuffle=True)
    with torch.no_grad():
        out, _ = spec.apply(params, {}, torch.from_numpy(test["features"]),
                            False)
    acc = accuracy(torch.from_numpy(test["label"]), out).item()
    assert acc > 0.8, acc


def test_resident_and_streaming_paths_agree_unshuffled():
    ds = _blobs(n=256)
    spec = torch_mlp(input_shape=(8,), hidden=(16,), num_classes=4,
                     dtype=torch.float32)
    out = []
    for resident in (True, False):
        t = trainers.ADAG(spec, loss="sparse_softmax_cross_entropy",
                          worker_optimizer="sgd", learning_rate=0.1,
                          num_workers=4, batch_size=8, communication_window=2,
                          num_epoch=2, device="cpu", device_data=resident,
                          prefetch=1 if resident else 2)
        out.append((t.train(ds), t.history.losses()))
    (pa, la), (pb, lb) = out
    assert la == lb
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


def test_later_slice_kwargs_raise_naming_their_roadmap_item(tmp_path):
    spec = torch_mlp(input_shape=(8,), hidden=(4,), num_classes=2)
    # elastic membership (A7.8) and the membership directory (A7.9), once
    # refused, are taken, each with the reference's check that it needs
    # backend="ps"
    with pytest.raises(ValueError, match="backend='ps'"):
        trainers.ADAG(spec, elastic=True, device="cpu")
    assert trainers.ADAG(spec, elastic=True, backend="ps",
                         device="cpu").elastic
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.ADAG(spec, directory=True, device="cpu")
    assert trainers.ADAG(spec, directory=True, backend="ps",
                         ps_transport="socket", device="cpu").directory
    # the checkpoint and EMA knobs (A8) are taken
    t = trainers.DynSGD(spec, checkpoint_dir="/nonexistent", resume=True,
                        checkpoint_async=True, ema_decay=0.5, device="cpu")
    assert (t.checkpoint_dir, t.resume, t.checkpoint_async, t.ema_decay) \
        == ("/nonexistent", True, True, 0.5)
    # W workers over processes (A12.2), the deploy streamer (A13's first
    # half) and the observability knobs (its second half) are taken, each
    # with the reference's check that it needs backend="ps"
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.SingleTrainer(spec, analyze=True, device="cpu")
    assert trainers.SingleTrainer(spec, analyze=True, backend="ps",
                                  device="cpu").trace
    # the flight recorder is taken on the collective backend too: it
    # records the engine's spans and writes the timeline
    import json

    from distkeras_tpu_torch.observability import trace as ttrace

    t = trainers.ADAG(torch_mlp(input_shape=(8,), hidden=(4,),
                                num_classes=4),
                      loss="sparse_softmax_cross_entropy",
                      trace_dir=str(tmp_path), num_workers=2,
                      batch_size=16, communication_window=2, num_epoch=1,
                      device="cpu")
    t.train(_blobs(n=128))
    assert t.trace_path_ and not ttrace.enabled()
    with open(t.trace_path_) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"engine.window", "engine.grads", "engine.forward",
            "engine.update", "engine.merge"} <= names
    assert isinstance(doc["otherData"]["unix_minus_monotonic_ns"], int)
    assert trainers.ADAG(spec, trace=True, device="cpu").trace
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.ADAG(spec, deploy_streamer=object(), device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        trainers.ADAG(spec, not_a_kwarg=1, device="cpu")
    t = trainers.ADAG(spec, backend="collective", ps_port=0, elastic=False,
                      device="cpu")                 # defaults are accepted
    assert t.communication_window == 12
    assert trainers.DynSGD(spec, device="cpu").communication_window == 10
    assert trainers.AEASGD(spec, device="cpu").learning_rate == 0.04
    with pytest.raises(TypeError, match="ModelSpec"):
        trainers.ADAG(object(), device="cpu")


def test_data_pipeline_matches_jax_package():
    rng = np.random.default_rng(5)
    cols = {"x": rng.normal(size=(103, 3)).astype(np.float32),
            "y": np.arange(103, dtype=np.int32)}
    jd, td = jdata.Dataset(cols), tdata.Dataset(cols)
    for seed in (None, 7):
        for a, b in zip(jd.superbatches(4, 5, 2, ["x", "y"], seed=seed),
                        td.superbatches(4, 5, 2, ["x", "y"], seed=seed)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        for cover in (False, True):
            for u, v in zip(
                    jd.worker_shards(4, 5, 2, ["x", "y"], seed=seed,
                                     cover_all=cover),
                    td.worker_shards(4, 5, 2, ["x", "y"], seed=seed,
                                     cover_all=cover)):
                np.testing.assert_array_equal(u, v)
    for (a, ra), (b, rb) in zip(jdata.padded_chunks(list(cols.values()), 40),
                                tdata.padded_chunks(list(cols.values()), 40)):
        assert ra == rb
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    placed = list(tdata.prefetch_to_device(
        td.superbatches(4, 5, 2, ["x", "y"]), tdata.place_on("cpu"), depth=2))
    assert len(placed) == 2 and isinstance(placed[0][0], torch.Tensor)
    assert placed[1][1].shape == (4, 2, 5)


@pytest.mark.parametrize("name", ["mnist", "cifar10", "higgs", "imdb"])
def test_synthetic_datasets_match_jax_package(name):
    kw = dict(n_train=64, n_test=16)
    jtrain, jtest = getattr(jds, name)(**kw)
    ttrain, ttest = getattr(tds, name)(**kw)
    for a, b in ((jtrain, ttrain), (jtest, ttest)):
        assert a.columns == b.columns
        for c in a.columns:
            np.testing.assert_array_equal(a[c], b[c])
