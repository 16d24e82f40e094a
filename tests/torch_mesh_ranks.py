"""One rank of the port's multi-process mesh tests.

``python tests/torch_mesh_ranks.py WORKDIR``, started once a rank by
``distkeras_tpu_torch.job_deployment.LocalRunner`` with the
``DISTKERAS_*`` coordinator environment: joins a gloo world on the CPU,
runs every case of ``WORKDIR/plan.json`` over ``WORKDIR/inputs.npz`` and
writes rank 0's results to ``WORKDIR/<case>.npz``. It imports torch and
the port only (never JAX, never a test module), so the parent compares
the results with the JAX package.

Case kinds: ``train`` (a ``MeshTrainer`` run: trained params and the loss
history; ``resume`` splits it at an epoch through a checkpoint), ``ring``
(``ring_attention``: output and input gradients), ``moe`` (``moe_mlp``:
output, aux and gradients) and ``pipeline_apply`` (a pipelined MLP
against ``sequential_apply``). W workers over processes: ``dp_train`` (a
``DistributedTrainer(mesh=)`` run of one of the five algorithms: center,
losses, validation records, EMA, worker 0's non-trainable state, every
rank's center checksum), ``worker_grads`` (sync BN's per-worker
gradients under the engine's vmap, gathered from every rank),
``predict`` (``ModelPredictor(mesh=)``), ``ps_train`` (the multi-process
``backend="ps"``) and ``refuse`` (the error a trainer or predictor
raises on every rank).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _model(cfg: dict):
    from distkeras_tpu_torch.models import (
        moe_transformer_classifier,
        transformer_classifier,
        transformer_lm_spec,
    )

    cfg = dict(cfg)
    kind = cfg.pop("kind")
    fn = {"classifier": transformer_classifier,
          "moe": moe_transformer_classifier, "lm": transformer_lm_spec}[kind]
    return fn(dtype=torch.float32, **cfg)


def _with_init(spec, data, prefix: str):
    params = {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
              for k in data.files if k.startswith(prefix)}
    _, state = spec.init(0)
    return dataclasses.replace(spec, init=lambda seed: (params, state))


def _dataset(data, lm: bool):
    """The classifier's ``(features, mask, label)`` or the LM's
    ``(features, label)`` next-token columns."""
    from distkeras_tpu_torch.data import Dataset

    if lm:
        return Dataset({"features": data["lm_tokens"],
                        "label": data["lm_label"]})
    return Dataset({"features": data["tokens"], "mask": data["mask"],
                    "label": data["label"]})


def _adam(case):
    from distkeras_tpu_torch import optim

    return optim.adam(case["lr"], eps=case.get("eps", 1e-8))


def run_train(case, data, workdir):
    from distkeras_tpu_torch.trainers import MeshTrainer

    spec = _with_init(_model(case["model"]), data, case["init"] + "/")
    lm = case["model"]["kind"] == "lm"
    feats = ["features"] if lm else ["features", "mask"]
    kw = dict(case.get("trainer", {}))
    epochs = kw.pop("num_epoch", 1)

    def trainer(n, **extra):
        return MeshTrainer(spec, worker_optimizer=_adam(case),
                           features_col=feats, batch_size=case["batch"],
                           num_epoch=n, device="cpu", **kw, **extra)

    if case.get("resume"):
        ck = os.path.join(workdir, case["name"] + "_ckpt")
        first = trainer(case["resume"], checkpoint_dir=ck)
        first.train(_dataset(data, lm))
        t = trainer(epochs, checkpoint_dir=ck, resume=True)
        params = t.train(_dataset(data, lm))
        files = sorted(os.listdir(ck))
    else:
        t = trainer(epochs)
        params = t.train(_dataset(data, lm))
        files = []
    losses = np.array([r["loss"] for r in t.history.records if "loss" in r],
                      np.float64)
    out = {f"p/{k}": v.detach().numpy() for k, v in params.items()}
    out["losses"] = losses
    out["files"] = np.array(files)
    t.close()
    return out


def run_ring(case, data, workdir):
    from distkeras_tpu_torch.parallel.mesh import Mesh
    from distkeras_tpu_torch.parallel.sequence import ring_attention

    mesh = Mesh(case["mesh"], device="cpu")
    q, k, v = (torch.from_numpy(np.array(data[n])).requires_grad_(True)
               for n in ("rq", "rk", "rv"))
    mask = torch.from_numpy(np.array(data["rmask"])) \
        if case.get("mask") else None
    out = ring_attention(q, k, v, mesh, axis=case["axis"],
                         causal=case["causal"], key_mask=mask,
                         window=case.get("window"))
    g = torch.from_numpy(np.array(data["rg"]))
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    return {"out": out.detach().numpy(), "dq": dq.numpy(), "dk": dk.numpy(),
            "dv": dv.numpy()}


def run_moe(case, data, workdir):
    from distkeras_tpu_torch.parallel.expert import moe_mlp
    from distkeras_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(case["mesh"], device="cpu")
    params = {k: torch.from_numpy(np.array(data[f"mlp/{k}"]))
              .requires_grad_(True) for k in ("gate", "w1", "b1", "w2", "b2")}
    x = torch.from_numpy(np.array(data["mx"])).requires_grad_(True)
    y, aux = moe_mlp(params, x, mesh, axis=case["axis"], top_k=case["top_k"],
                     capacity_factor=case["capacity_factor"])
    obj = torch.mean(y ** 2) + 0.01 * aux
    grads = torch.autograd.grad(obj, list(params.values()) + [x])
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy()}
    for name, g in zip(list(params) + ["x"], grads):
        out[f"g/{name}"] = g.numpy()
    return out


def run_pipeline_apply(case, data, workdir):
    from distkeras_tpu_torch.parallel.mesh import Mesh
    from distkeras_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = Mesh(case["mesh"], device="cpu")
    w = torch.from_numpy(np.array(data["pw"])).requires_grad_(True)
    x = torch.from_numpy(np.array(data["px"]))

    def stage(p, act):
        return (torch.tanh(act[0] @ p["w"]),)

    (y,) = pipeline_apply(stage, {"w": w}, (x,), mesh, axis=case["axis"],
                          microbatches=case["microbatches"])
    # backward(), not autograd.grad(..., (w,)): a stage's receive lies on
    # no path to w, and grad() would prune the send of its gradient
    torch.sum(y ** 2).backward()
    return {"y": y.detach().numpy(), "gw": w.grad.numpy()}


def run_mesh_size(case, data, workdir):
    """A mesh of fewer ranks than the world raises on every rank, before
    any collective, through ``Mesh`` and through ``MeshTrainer``."""
    from distkeras_tpu_torch.parallel.mesh import Mesh
    from distkeras_tpu_torch.trainers import MeshTrainer

    out = {}
    for name, make in (
            ("mesh", lambda: Mesh(case["mesh"], device="cpu")),
            ("trainer", lambda: MeshTrainer(_model(case["model"]),
                                            mesh_shape=case["mesh"],
                                            device="cpu"))):
        try:
            make()
            out[name] = np.array("")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


def _dp_spec(case, data):
    """The case's model (``mlp`` or ``resnet``) with the JAX init stored
    under ``case["init"]``."""
    from distkeras_tpu_torch.models import mlp, resnet_small

    cfg = dict(case["model"])
    kind = cfg.pop("kind")
    if "input_shape" in cfg:
        cfg["input_shape"] = tuple(cfg["input_shape"])
    if "hidden" in cfg:
        cfg["hidden"] = tuple(cfg["hidden"])
    if "widths" in cfg:
        cfg["widths"] = tuple(cfg["widths"])
    fn = {"mlp": mlp, "resnet": resnet_small}[kind]
    return _with_init(fn(dtype=torch.float32, **cfg), data,
                      case["init"] + "/")


def _xy(data, case):
    from distkeras_tpu_torch.data import Dataset

    x, y = data[case.get("x", "x")], data[case.get("y", "y")]
    if case.get("sorted"):
        order = np.argsort(y, kind="stable")
        x, y = x[order], y[order]
    return Dataset({"features": x, "label": y})


def _checksum(params) -> float:
    return float(sum(np.dot(np.asarray(v, np.float64).ravel(),
                            np.arange(1, v.numel() + 1, dtype=np.float64))
                     for _, v in sorted(params.items())))


def _everyone(value):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _dp_trainer(case, data, workdir, **extra):
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.parallel.mesh import get_mesh

    kw = dict(case.get("trainer", {}))
    for k in ("checkpoint_dir",):
        if k in kw:
            kw[k] = os.path.join(workdir, kw[k]) \
                if not os.path.isabs(kw[k]) else kw[k]
    if case.get("validation"):
        kw["validation_data"] = _xy(data, {"x": "vx", "y": "vy"})
    kw.update(extra)
    cls = getattr(trainers, case["algo"])
    mesh = get_mesh(device="cpu") if case.get("mesh", True) else None
    return cls(_dp_spec(case, data), device="cpu", mesh=mesh,
               loss="sparse_softmax_cross_entropy", **kw)


def run_dp_train(case, data, workdir):
    import warnings

    shuffle = case.get("shuffle", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if case.get("resume_at"):
            # the same run split at an epoch through its checkpoint
            _dp_trainer(case, data, workdir,
                        num_epoch=case["resume_at"]).train(
                _xy(data, case), shuffle=shuffle)
            t = _dp_trainer(case, data, workdir, resume=True)
        else:
            t = _dp_trainer(case, data, workdir)
        params = t.train(_xy(data, case), shuffle=shuffle)
    out = {f"p/{k}": v.detach().numpy() for k, v in params.items()}
    out["losses"] = np.array(t.history.losses(), np.float64)
    out["checksums"] = np.array(_everyone(_checksum(params)))
    out["nt_checksums"] = np.array(_everyone(_checksum(t.trained_nt_)))
    for k, v in t.trained_nt_.items():
        out[f"nt/{k}"] = v.numpy()
    vals = [r for r in t.history.records if "val_loss" in r]
    out["val_loss"] = np.array([r["val_loss"] for r in vals])
    out["val_accuracy"] = np.array([r.get("val_accuracy", -1.0)
                                    for r in vals])
    out["val_everyone"] = np.array(_everyone([r["val_loss"] for r in vals]))
    if t.ema_params_ is not None:
        for k, v in t.ema_params_.items():
            out[f"ema/{k}"] = v.numpy()
    out["warnings"] = np.array([str(w.message) for w in caught] or [""])
    ck = case.get("trainer", {}).get("checkpoint_dir")
    out["files"] = np.array(sorted(os.listdir(os.path.join(workdir, ck)))
                            if ck and not os.path.isabs(ck) else [])
    return out


def run_worker_grads(case, data, workdir):
    """Every worker's gradient of ``sum(out * cot)`` for W stacked
    workers spread over the ranks (``W / dp`` a rank), under the engine's
    ``dp`` context, as ``jax.vmap(grad, axis_name=WORKER_AXIS)`` takes
    them over all W at once."""
    from distkeras_tpu_torch.parallel import local_sgd
    from distkeras_tpu_torch.parallel.mesh import get_mesh, worker_slice

    spec = _dp_spec(case, data)
    mesh = get_mesh(device="cpu")
    sl = worker_slice(mesh, case["workers"])
    ps = {k[3:]: torch.from_numpy(np.array(data[k]))[sl]
          for k in data.files if k.startswith("gp/")}
    _, st = spec.init(0)
    nts = {k: v[None].expand(sl.stop - sl.start, *v.shape).clone()
           for k, v in st.items()}
    x = torch.from_numpy(np.array(data["gx"]))[sl]
    cot = torch.from_numpy(np.array(data["gcot"]))[sl]

    def f(params, nt_, xx, cc):
        def obj(p):
            out, new = spec.apply(p, nt_, xx, True)
            return torch.sum(out * cc), (out, new)

        return torch.func.grad(obj, has_aux=True)(params)

    with local_sgd._over_ranks(mesh.group("dp")):
        grads, (out, new) = torch.func.vmap(f)(ps, nts, x, cot)
    res = {}
    for name, tree in (("g", grads), ("nt", new)):
        for k, v in tree.items():
            parts = _everyone(v.detach().numpy())
            res[f"{name}/{k}"] = np.concatenate(parts)
    res["out"] = np.concatenate(_everyone(out.detach().numpy()))
    return res


def run_predict(case, data, workdir):
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.parallel.mesh import get_mesh

    spec = _dp_spec(case, data)
    params, state = spec.init(0)
    pred = ModelPredictor(spec, params, state, batch_size=case["batch"],
                          mesh=get_mesh(device="cpu"), device="cpu")
    out = pred.predict(_xy(data, case))["prediction"]
    return {"prediction": out,
            "everyone": np.array(_everyone(float(np.sum(out))))}


def run_ps_train(case, data, workdir):
    """The multi-process PS: DOWNPOUR over label-sorted rows; every
    rank's center checksum, its worker ids and losses."""
    from distkeras_tpu_torch import native_ps, trainers, workers

    ids = set()

    def recording(cls, pos):
        class Client(cls):
            def __init__(self, *args, **kw):
                ids.add(int(args[pos]))
                super().__init__(*args, **kw)

        return Client

    # the worker ids this rank's clients speak to the server under
    workers.ParameterServerClient = recording(
        workers.ParameterServerClient, 2)
    native_ps.NativePSClient = recording(native_ps.NativePSClient, 2)
    kw = dict(case["trainer"])
    t = trainers.DOWNPOUR(_dp_spec(case, data), device="cpu",
                          loss="sparse_softmax_cross_entropy",
                          backend="ps", **kw)
    try:
        params = t.train(_xy(data, case), shuffle=True)
    finally:
        workers.ParameterServerClient = workers.ParameterServerClient.__base__
        native_ps.NativePSClient = native_ps.NativePSClient.__base__
    losses = [r["loss"] for r in t.history.records if "loss" in r]
    ids = sorted(i for i in ids if i < 2**31)   # not the final pull's
    return {"checksums": np.array(_everyone(_checksum(params))),
            "losses": np.array(losses, np.float64),
            "ids": np.array(_everyone(ids)),
            "labels": np.array(_everyone(sorted(set(
                np.asarray(_xy(data, case)["label"])[
                    int(os.environ["DISTKERAS_PROCESS_ID"])::
                    int(os.environ["DISTKERAS_NUM_PROCESSES"])].tolist()))))}


def run_refuse(case, data, workdir):
    """The error (type: message) each named construction or run raises."""
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.parallel.mesh import get_mesh
    from distkeras_tpu_torch.predictors import ModelPredictor

    spec = _dp_spec(case, data)
    ds = _xy(data, case)
    out = {}
    for name, kw in case["trials"].items():
        kw = dict(kw)
        what = kw.pop("what")
        try:
            if what == "predictor":
                params, state = spec.init(0)
                ModelPredictor(spec, params, state, device="cpu",
                               mesh=get_mesh(device="cpu"), **kw)
            elif what == "collective":
                trainers.ADAG(spec, device="cpu", mesh=get_mesh(device="cpu"),
                              **kw)
            else:
                trainers.DOWNPOUR(spec, device="cpu", backend="ps",
                                  loss="sparse_softmax_cross_entropy",
                                  batch_size=8, communication_window=1,
                                  **kw).train(ds)
            out[name] = np.array("")
        except Exception as e:  # noqa: BLE001
            out[name] = np.array(f"{type(e).__name__}: {e}")
    return out


def main() -> int:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from distkeras_tpu_torch.job_deployment import initialize_cluster

    workdir = sys.argv[1]
    info = initialize_cluster(device="cpu", timeout=120.0)
    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    runners = {"train": run_train, "ring": run_ring, "moe": run_moe,
               "pipeline_apply": run_pipeline_apply,
               "mesh_size": run_mesh_size, "dp_train": run_dp_train,
               "worker_grads": run_worker_grads, "predict": run_predict,
               "ps_train": run_ps_train, "refuse": run_refuse}
    for case in plan["cases"]:
        out = runners[case["kind"]](case, data, workdir)
        if info["process_index"] == 0:
            np.savez(os.path.join(workdir, case["name"] + ".npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
