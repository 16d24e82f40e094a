"""W workers over processes (``DistributedTrainer(mesh=)``,
``ModelPredictor(mesh=)``): gloo worlds of 2 and 4 ranks on the CPU,
brought up by ``job_deployment.LocalRunner`` (``tests/torch_mesh_ranks.py``
a rank), held against the JAX package's single-process 8-device trainer
with W = 8 (``tests/conftest.py``'s fake CPU mesh) and against the port's
own single-process run.

- ADAG, DOWNPOUR, AEASGD, EAMSGD and DynSGD with W = 8 over 4 ranks (two
  workers a rank), streaming and shuffled, equal the JAX run: DynSGD's
  staleness scale takes the global worker index, not the rank's. ADAG
  also scores ``validation_data`` (every rank's records equal) and keeps
  ``ema_params_``. ``SingleTrainer`` over a mesh of one equals the JAX
  ``SingleTrainer``.
- The resident path with ``shuffle=True`` draws every worker's
  permutation on every rank and keeps its own rows, so a 4-rank run equals
  the port's single-process run (whose permutations the JAX package does
  not draw).
- Sync BatchNorm (``resnet_small(sync_bn=True)``): the per-worker
  gradients of W = 8 workers over 4 ranks equal ``jax.vmap(grad,
  axis_name=WORKER_AXIS)`` over all 8, and an ADAG window over 2 ranks
  equals the JAX trainer's.
- The process-sharded ``.dks``: a 2-rank run split at an epoch equals the
  uninterrupted run; a 4-rank checkpoint resumes elastically into 2 ranks
  with another W (the center re-broadcast, as the port's single-process
  resume of the same files); a ``.dkc`` the JAX package wrote resumes
  into 2 ranks, each rank building its own workers from its center.
- ``ModelPredictor(mesh=)`` over 4 ranks returns the JAX mesh predictor's
  rows on every rank; the refusals (``W % dp``, ``W < dp``,
  ``batch_size % dp``) raise on every rank.

Tolerances (f32): against the JAX package, parameters 2e-5 absolute and
losses 1e-5 relative (as ``test_torch_mesh.py``), sync BN's gradients as
``test_torch_resnet.py`` (1e-4 relative, 1e-6 absolute); against the
port's own single-process run, and a resumed run against the
uninterrupted one, 2e-6 absolute (the same math, its sums over ranks in
another order).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu import predictors as jpred
from distkeras_tpu.data import Dataset as JDataset
from distkeras_tpu.models import mlp as jmlp
from distkeras_tpu.models import resnet_small as jresnet
from distkeras_tpu.parallel.local_sgd import WORKER_AXIS
from distkeras_tpu.parallel.mesh import get_mesh as jget_mesh
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import (
    params_to_jax,
    state_to_jax,
    tensors_from_jax,
)
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import mlp as tmlp
from distkeras_tpu_torch.models import resnet_small as tresnet
from distkeras_tpu_torch.parallel.mesh import get_mesh
from tests.test_torch_mesh import (
    LOSS_RTOL,
    PARAM_TOL,
    SELF_TOL,
    init_inputs,
    one_thread,
    run_world,
)

W, B, WIN, ROWS, EPOCHS = 8, 8, 2, 256, 2
ALGOS = ["ADAG", "DOWNPOUR", "AEASGD", "EAMSGD", "DynSGD"]
MLP = dict(input_shape=(8,), hidden=(16,), num_classes=4)
RESNET = dict(widths=(4, 8), input_shape=(8, 8, 3), num_classes=4)
GRADS = dict(rtol=1e-4, atol=1e-6)
#: streaming unless a case asks for the resident path: the JAX package's
#: resident shuffle draws its permutations with ``jax.random``
COMMON = dict(worker_optimizer="sgd", learning_rate=0.05, num_workers=W,
              batch_size=B, communication_window=WIN, num_epoch=EPOCHS,
              seed=0, device_data=False)


def _blobs(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, n).astype(np.int32)
    centers = np.random.default_rng(99).normal(0, 3, (4, 8))
    x = (centers[y] + rng.normal(0, 0.5, (n, 8))).astype(np.float32)
    return x, y


def _inputs():
    x, y = _blobs(ROWS, 0)
    vx, vy = _blobs(40, 1)
    rng = np.random.default_rng(2)
    return {"x": x, "y": y, "vx": vx, "vy": vy,
            "ix": rng.normal(size=(64, 8, 8, 3)).astype(np.float32),
            "iy": rng.integers(0, 4, 64).astype(np.int32)}


D = _inputs()


def _jspec(kind):
    if kind == "mlp":
        return jmlp(dtype=jnp.float32, **MLP)
    return jresnet(dtype=jnp.float32, sync_bn=True, **RESNET)


def _tspec(kind):
    if kind == "mlp":
        return tmlp(dtype=torch.float32, **MLP)
    return tresnet(dtype=torch.float32, sync_bn=True, **RESNET)


_INITS = {}


def _init(kind):
    """The JAX init of seed 0 (numpy trees) and the same weights by the
    port's leaf names."""
    if kind not in _INITS:
        p, nt = jax.tree.map(np.asarray,
                             jax.jit(_jspec(kind).init)(jax.random.PRNGKey(0)))
        tp = {k: v.numpy() for k, v in
              tensors_from_jax(p, _tspec(kind).module).items()}
        _INITS[kind] = (p, nt, tp)
    return _INITS[kind]


def _port_spec(kind):
    _, _, tp = _init(kind)
    spec = _tspec(kind)
    _, state = spec.init(0)
    init = {k: torch.from_numpy(v) for k, v in tp.items()}
    return dataclasses.replace(spec, init=lambda seed: (init, state))


def _model_cfg(kind):
    cfg = dict(MLP if kind == "mlp" else dict(RESNET, sync_bn=True))
    return {"kind": "mlp" if kind == "mlp" else "resnet", **cfg}


#: the elastic rules' force: alpha = rho · lr = 0.05, W · alpha < 1
ELASTIC = {"AEASGD": dict(rho=1.0), "EAMSGD": dict(rho=1.0)}


def _case(name, algo, kind="mlp", **trainer):
    return {"kind": "dp_train", "name": name, "algo": algo,
            "model": _model_cfg(kind), "init": kind,
            "trainer": {**COMMON, **ELASTIC.get(algo, {}), **trainer},
            "shuffle": True}


def _jax_train(algo, kind="mlp", xy=("x", "y"), shuffle=True, **kw):
    """The JAX trainer on its 8-device mesh: ``(trainer, center)``."""
    kw = {**COMMON, **ELASTIC.get(algo, {}), **kw}
    cls = getattr(jdk, algo)
    if algo == "SingleTrainer":
        for k in ("num_workers", "communication_window", "device_data"):
            kw.pop(k)
    t = cls(_jspec(kind), loss="sparse_softmax_cross_entropy", **kw)
    ds = JDataset({"features": D[xy[0]], "label": D[xy[1]]})
    return t, jax.device_get(t.train(ds, shuffle=shuffle))


def _port_ds(xy=("x", "y")):
    return Dataset({"features": D[xy[0]], "label": D[xy[1]]})


def _port_train(algo, kind="mlp", mesh=None, xy=("x", "y"), shuffle=True,
                **kw):
    """The port's single-process run: ``(trainer, center)``."""
    kw = {**COMMON, **kw}
    if algo == "SingleTrainer":
        for k in ("num_workers", "communication_window", "device_data"):
            kw.pop(k)
    t = getattr(trainers, algo)(_port_spec(kind), device="cpu", mesh=mesh,
                                loss="sparse_softmax_cross_entropy", **kw)
    with one_thread():
        return t, t.train(_port_ds(xy), shuffle=shuffle)


def _params(out, prefix="p/"):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _match_jax(port: dict, jtree, kind, tol=PARAM_TOL):
    want = {k: v.numpy() for k, v in
            tensors_from_jax(jtree, _tspec(kind).module).items()}
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(port[k]), want[k], rtol=0,
                                   atol=tol, err_msg=k)


def _match(port: dict, want: dict, tol=SELF_TOL):
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(port[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


# -- the worlds ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX ADAG run (W = 8, one epoch) that wrote its ``.dkc``; two
    copies, one for the 2-rank resume and one for the single-process
    one."""
    root = tmp_path_factory.mktemp("jck")
    _jax_train("ADAG", num_epoch=1, checkpoint_dir=str(root / "jck"))
    for name in ("a", "b"):
        shutil.copytree(root / "jck", root / name)
    return root


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp4")
    cases = [_case(a.lower(), a) for a in ALGOS]
    cases[0]["trainer"]["ema_decay"] = 0.9
    cases[0]["validation"] = True
    cases.append(_case("resident", "DynSGD", device_data=True))
    cases.append({**_case("ckpt4", "ADAG", num_workers=4, num_epoch=1,
                          checkpoint_dir=str(root / "ck4")),
                  "shuffle": False})
    cases.append({"kind": "worker_grads", "name": "bn_grads",
                  "model": _model_cfg("resnet"), "init": "resnet",
                  "workers": W})
    cases.append({"kind": "predict", "name": "predict", "batch": 16,
                  "model": _model_cfg("mlp"), "init": "mlp", "x": "vx",
                  "y": "vy"})
    cases.append({"kind": "refuse", "name": "refuse",
                  "model": _model_cfg("mlp"), "init": "mlp", "trials": {
                      "w_mod_dp": {"what": "collective", "num_workers": 6},
                      "w_lt_dp": {"what": "collective", "num_workers": 2},
                      "batch_mod_dp": {"what": "predictor",
                                       "batch_size": 10}}})
    out = run_world(4, cases, _world_inputs(), root, timeout=240.0)
    for name in ("a", "b"):
        shutil.copytree(root / "ck4", root / f"ck4_{name}")
    out["root"] = root
    return out


def _world_inputs():
    rng = np.random.default_rng(4)
    _, _, rp = _init("resnet")
    grads_in = {
        "gx": rng.normal(size=(W, 4, 8, 8, 3)).astype(np.float32),
        "gcot": rng.normal(size=(W, 4, 4)).astype(np.float32)}
    for k, v in rp.items():
        grads_in[f"gp/{k}"] = np.stack(
            [v + 0.05 * i * rng.normal(size=v.shape).astype(np.float32)
             for i in range(W)]).astype(np.float32)
    return {**D, **init_inputs("mlp", _init("mlp")[2]),
            **init_inputs("resnet", _init("resnet")[2]), **grads_in}


@pytest.fixture(scope="module")
def world2(world4, jax_ckpt, tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2")
    cases = [
        {**_case("full", "ADAG", checkpoint_dir="ck_full"),
         "shuffle": False},
        {**_case("resumed", "ADAG", checkpoint_dir="ck_res"),
         "shuffle": False, "resume_at": 1},
        {**_case("elastic", "ADAG", num_workers=2,
                 checkpoint_dir=str(world4["root"] / "ck4_a"), resume=True),
         "shuffle": False},
        {**_case("from_jax", "ADAG", checkpoint_dir=str(jax_ckpt / "a"),
                 resume=True), "shuffle": False},
        {**_case("bn_adag", "ADAG", kind="resnet", num_workers=W,
                 batch_size=4, num_epoch=1), "x": "ix", "y": "iy",
         "shuffle": False},
    ]
    return run_world(2, cases, _world_inputs(), root, timeout=240.0)


# -- four ranks against the JAX package --------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_four_ranks_equal_the_jax_eight_device_run(world4, algo):
    jt, jcenter = _jax_train(algo)
    out = world4[algo.lower()]
    np.testing.assert_allclose(out["losses"], jt.history.losses(),
                               rtol=LOSS_RTOL)
    _match_jax(_params(out), jcenter, "mlp")
    # every rank returned the same center and worker 0's state
    assert len(set(out["checksums"].tolist())) == 1
    assert len(set(out["nt_checksums"].tolist())) == 1


def test_validation_and_ema_over_four_ranks(world4):
    jt, _ = _jax_train("ADAG", ema_decay=0.9, validation_data=JDataset(
        {"features": D["vx"], "label": D["vy"]}))
    out = world4["adag"]
    jval = [r for r in jt.history.records if "val_loss" in r]
    assert len(out["val_loss"]) == len(jval) == EPOCHS
    np.testing.assert_allclose(out["val_loss"],
                               [r["val_loss"] for r in jval], rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["val_accuracy"],
                               [r["val_accuracy"] for r in jval], atol=1e-9)
    # every rank scored the same center: equal records
    assert all(list(v) == list(out["val_everyone"][0])
               for v in out["val_everyone"])
    _match_jax(_params(out, "ema/"), jt.ema_params_, "mlp")


def test_dynsgd_uses_the_global_worker_index():
    """The staleness scale of a rank's workers starts at its first global
    worker: rank 1 of 2 with W = 4 scales its workers by 1/3 and 1/4."""
    from distkeras_tpu.parallel.merge_rules import DynSGDMerge as JDyn
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge

    rng = np.random.default_rng(0)
    center = rng.normal(size=(3,)).astype(np.float32)
    workers = rng.normal(size=(4, 3)).astype(np.float32)
    want, _ = JDyn().merge({"w": center}, {"w": workers})
    halves = [DynSGDMerge().merge(
        {"w": torch.from_numpy(center)},
        {"w": torch.from_numpy(workers[2 * r:2 * r + 2])},
        axis=_Axis(None, 2 * r, 4))[0]["w"] - torch.from_numpy(center)
        for r in (0, 1)]
    got = torch.from_numpy(center) + halves[0] + halves[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want["w"]), rtol=0,
                               atol=1e-6)


def _Axis(group, start, total):
    from distkeras_tpu_torch.parallel.merge_rules import WorkerAxis

    return WorkerAxis(group, start, total)


def test_resident_shuffle_over_ranks_equals_one_process(world4):
    t, center = _port_train("DynSGD", device_data=True)
    out = world4["resident"]
    np.testing.assert_allclose(out["losses"], t.history.losses(),
                               rtol=0, atol=SELF_TOL)
    _match(_params(out), {k: v.numpy() for k, v in center.items()})


def test_single_trainer_over_a_mesh_of_one_equals_jax():
    # unshuffled: SingleTrainer walks a resident epoch, whose shuffle
    # draws other permutations in each package
    jt, jcenter = _jax_train("SingleTrainer", shuffle=False)
    mesh = get_mesh(1, device="cpu")
    try:
        t, center = _port_train("SingleTrainer", mesh=mesh, shuffle=False)
    finally:
        mesh.close()
    np.testing.assert_allclose(t.history.losses(), jt.history.losses(),
                               rtol=LOSS_RTOL)
    _match_jax({k: v.numpy() for k, v in center.items()}, jcenter, "mlp")


# -- sync BatchNorm across ranks ---------------------------------------------

def test_sync_bn_gradients_over_ranks_equal_jax_worker_axis(world4):
    jspec = _jspec("resnet")
    p, nt, _ = _init("resnet")
    inp = _world_inputs()
    jparams = jax.tree.map(
        lambda a: a, {k[3:]: inp[k] for k in inp if k.startswith("gp/")})
    # the port's stacked leaves, back in flax's tree, one worker at a time
    module = _tspec("resnet").module
    ps = [params_to_jax({k: torch.from_numpy(v[i])
                         for k, v in jparams.items()}, module)
          for i in range(W)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *ps)
    nts = jax.tree.map(lambda a: np.stack([a] * W), nt)

    def grads(pp, nn_, xx, cc):
        def f(params):
            out, new = jspec.apply(params, nn_, xx, True)
            return jnp.sum(out * cc), (out, new)

        return jax.grad(f, has_aux=True)(pp)

    jg, (jout, jnt) = jax.jit(jax.vmap(grads, axis_name=WORKER_AXIS))(
        stacked, nts, inp["gx"], inp["gcot"])
    out = world4["bn_grads"]
    np.testing.assert_allclose(out["out"], np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    for i in range(W):
        g = params_to_jax({k[2:]: torch.from_numpy(v[i])
                           for k, v in out.items() if k.startswith("g/")},
                          module)
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x[i], jg)),
                        jax.tree.leaves(g)):
            np.testing.assert_allclose(b, np.asarray(a), **GRADS)
        st = state_to_jax({k[3:]: torch.from_numpy(v[i])
                           for k, v in out.items() if k.startswith("nt/")},
                          module)
        for a, b in zip(jax.tree.leaves(jax.tree.map(
                lambda x: x[i], jnt["batch_stats"])), jax.tree.leaves(st)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_sync_bn_adag_over_two_ranks_equals_jax(world2):
    jt, jcenter = _jax_train("ADAG", kind="resnet", batch_size=4,
                             num_epoch=1, xy=("ix", "iy"), shuffle=False)
    out = world2["bn_adag"]
    np.testing.assert_allclose(out["losses"], jt.history.losses(),
                               rtol=LOSS_RTOL)
    _match_jax(_params(out), jcenter, "resnet")
    st = state_to_jax({k[3:]: torch.from_numpy(v) for k, v in out.items()
                       if k.startswith("nt/")}, _tspec("resnet").module)
    for a, b in zip(jax.tree.leaves(jt.trained_nt_["batch_stats"]),
                    jax.tree.leaves(st)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_TOL)
    assert len(set(out["nt_checksums"].tolist())) == 1


# -- checkpoints ---------------------------------------------------------------

def test_sharded_resume_over_two_ranks_equals_the_uninterrupted_run(world2):
    full, resumed = world2["full"], world2["resumed"]
    _match(_params(resumed), _params(full))
    np.testing.assert_allclose(resumed["losses"], full["losses"][
        len(full["losses"]) // 2:], rtol=0, atol=SELF_TOL)
    # one file a rank and the meta a step: the process-sharded .dks
    files = list(full["files"])
    step1 = [f for f in files if "000000000001." in f]
    assert sorted(f.split(".")[1] for f in step1) == \
        ["meta", "p00000of00002", "p00001of00002"], files


def test_four_rank_checkpoint_resumes_elastically_into_two(world4, world2):
    out = world2["elastic"]
    assert any("elastic resume" in w for w in out["warnings"]), \
        out["warnings"]
    t, center = _port_train("ADAG", num_workers=2, resume=True,
                            checkpoint_dir=str(world4["root"] / "ck4_b"),
                            shuffle=False)
    _match(_params(out), {k: v.numpy() for k, v in center.items()})
    np.testing.assert_allclose(out["losses"], t.history.losses(), rtol=0,
                               atol=SELF_TOL)


def test_jax_written_dkc_resumes_into_two_ranks(jax_ckpt, world2):
    out = world2["from_jax"]
    assert any("elastic resume" in w for w in out["warnings"])
    t, center = _port_train("ADAG", resume=True,
                            checkpoint_dir=str(jax_ckpt / "b"),
                            shuffle=False)
    assert len(out["losses"]) == len(t.history.losses()) > 0
    _match(_params(out), {k: v.numpy() for k, v in center.items()})
    assert len(set(out["checksums"].tolist())) == 1


# -- the predictor and the refusals -------------------------------------------------

def test_mesh_predictor_over_four_ranks_equals_the_jax_mesh_predictor(world4):
    p, nt, _ = _init("mlp")
    want = jpred.ModelPredictor(
        _jspec("mlp"), p, nt, batch_size=16, mesh=jget_mesh(8)).predict(
        JDataset({"features": D["vx"]}))["prediction"]
    out = world4["predict"]
    assert out["prediction"].shape == (40, 4)
    np.testing.assert_allclose(out["prediction"], np.asarray(want), rtol=0,
                               atol=PARAM_TOL)
    assert len(set(out["everyone"].tolist())) == 1


def test_refusals_over_four_ranks(world4):
    out = world4["refuse"]
    assert str(out["w_mod_dp"]).startswith("ValueError: num_workers=6 is "
                                           "not a multiple")
    assert str(out["w_lt_dp"]).startswith("ValueError: num_workers=2 is "
                                          "smaller than")
    assert str(out["batch_mod_dp"]) == (
        "ValueError: batch_size 10 not divisible by mesh axis 'dp' of "
        "size 4")
