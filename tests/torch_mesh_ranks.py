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
against ``sequential_apply``).
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
               "mesh_size": run_mesh_size}
    for case in plan["cases"]:
        out = runners[case["kind"]](case, data, workdir)
        if info["process_index"] == 0:
            np.savez(os.path.join(workdir, case["name"] + ".npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
