"""The parallelism portfolio on the port in one script: dp, tp, fsdp, pp,
sp, ep. The twin of ``examples/parallelism.py``.

Each section runs one strategy end to end over the ranks of the world:
one process a device, explicit collectives over ``torch.distributed``.
With no launcher the world is this process alone; ``job_deployment.Job``
starts N ranks of this script with the ``DISTKERAS_*`` environment that
``initialize_cluster`` reads (gloo on the CPU, NCCL on the card, one
card a rank), and every mesh below is derived from N exactly as the JAX
example derives it from its device count::

    python -m distkeras_tpu_torch.examples.parallelism
    python -m distkeras_tpu_torch.examples.parallelism --device cpu --quick

Run ``--only tp`` (dp/tp/fsdp/pp/sp/ep) to demo one strategy. ``main``
returns each demo's record (its step losses, and ``acc`` for dp);
``--records PATH`` also writes them to PATH from rank 0.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from distkeras_tpu_torch.utils import resolve_device

def scale(n, quick):
    """--quick halves rows and epochs (results stay meaningful)."""
    return max(1, n // 2) if quick else n


def make_task(rng, n, vocab=64, maxlen=16, classes=4):
    """Tokens whose high bits encode the class — learnable in seconds."""
    y = rng.integers(0, classes, size=(n,)).astype(np.int32)
    toks = (
        y[:, None] * (vocab // classes)
        + rng.integers(0, vocab // classes, size=(n, maxlen))
    ).astype(np.int32)
    mask = np.ones((n, maxlen), np.float32)
    return toks, mask, y


def _losses(trainer) -> list:
    return [r["loss"] for r in trainer.history.records if "loss" in r]


def _mesh_run(spec, mesh_shape, rng, device, quick, maxlen=16,
              **kw) -> list:
    """Train ``spec`` with ``MeshTrainer`` on ``mesh_shape`` over the
    world (the example's rows, optimizer and epochs) and return its
    losses; a world of one the trainer made is destroyed after."""
    from distkeras_tpu_torch import MeshTrainer
    from distkeras_tpu_torch.data import Dataset

    toks, mask, y = make_task(rng, scale(256, quick), maxlen=maxlen)
    ds = Dataset({"features": toks, "mask": mask, "label": y})
    trainer = MeshTrainer(
        spec, worker_optimizer="adam", learning_rate=2e-3,
        mesh_shape=mesh_shape, batch_size=32, num_epoch=scale(6, quick),
        features_col=["features", "mask"], label_col="label",
        device=device, **kw)
    try:
        trainer.train(ds, shuffle=True)
    finally:
        trainer.close()
    return _losses(trainer)


def _classifier(depth=2, maxlen=16):
    from distkeras_tpu_torch.models import transformer_classifier

    return transformer_classifier(vocab=64, maxlen=maxlen, dim=64, heads=4,
                                  depth=depth, num_classes=4,
                                  dtype=torch.float32)


def demo_dp(n_devices, device, quick):
    """Data parallelism: the reference's own API — ADAG over the world."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.datasets import mnist
    from distkeras_tpu_torch.models import mlp
    from distkeras_tpu_torch.parallel.mesh import get_mesh

    train, test = mnist(n_train=scale(256, quick) * n_devices, n_test=512)
    mesh = get_mesh(n_devices, device=device) if n_devices > 1 else None
    trainer = ADAG(
        mlp(dtype=torch.float32), loss="sparse_softmax_cross_entropy",
        worker_optimizer="adam", learning_rate=1e-3,
        num_workers=n_devices, batch_size=32, communication_window=4,
        num_epoch=scale(3, quick), device=device, mesh=mesh,
    )
    params = trainer.train(train, shuffle=True)
    with torch.no_grad():
        out, _ = trainer.spec.apply(
            {k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in trainer.trained_nt_.items()},
            torch.as_tensor(test["features"], device=device), False)
    acc = float(np.mean(out.argmax(-1).cpu().numpy() == test["label"]))
    print(f"[dp] ADAG, {n_devices} workers over the world: test acc "
          f"{acc:.3f}")
    return dict(acc=acc, losses=[float(x) for x in
                                 trainer.get_history().losses()])


def demo_tp(n_devices, rng, device, quick):
    """Tensor parallelism: MeshTrainer shards the transformer's weights."""
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    losses = _mesh_run(_classifier(), {"dp": dp, "tp": tp}, rng, device,
                       quick)
    print(f"[tp] MeshTrainer dp={dp}×tp={tp}: loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}")
    return dict(losses=losses)


def demo_fsdp(n_devices, rng, device, quick):
    """FSDP/ZeRO-3: params + adam moments sharded over dp, grad_accum=2."""
    losses = _mesh_run(_classifier(), {"dp": n_devices}, rng, device,
                       quick, parameter_sharding="fsdp", grad_accum=2)
    print(f"[fsdp] ZeRO-3 over {n_devices} ranks (grad_accum=2): loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}")
    return dict(losses=losses)


def demo_pp(n_devices, rng, device, quick):
    """Pipeline parallelism: the transformer's blocks as GPipe stages —
    one trainer call, each rank storing exactly its stage."""
    pp = 4 if n_devices % 4 == 0 else n_devices
    dp = n_devices // pp
    losses = _mesh_run(_classifier(depth=pp),
                       {"dp": dp, "pp": pp} if dp > 1 else {"pp": pp},
                       rng, device, quick, strategy="pipeline")
    print(f"[pp] MeshTrainer GPipe dp={dp}×pp={pp}: loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}")
    return dict(losses=losses)


def demo_sp(n_devices, rng, device, quick):
    """Sequence parallelism: ring attention, context sharded over ranks —
    one trainer call."""
    sp = 4 if n_devices % 4 == 0 else n_devices
    dp = n_devices // sp
    L = 16 * sp
    losses = _mesh_run(_classifier(maxlen=L),
                       {"dp": dp, "sp": sp} if dp > 1 else {"sp": sp},
                       rng, device, quick, maxlen=L, strategy="sequence")
    print(f"[sp] MeshTrainer ring attention dp={dp}×sp={sp}, L={L}: loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}")
    return dict(losses=losses)


def demo_ep(n_devices, rng, device, quick):
    """Expert parallelism: GShard MoE, experts exchanged via all_to_all —
    one trainer call."""
    from distkeras_tpu_torch.models import moe_transformer_classifier

    dp = 2 if n_devices % 2 == 0 else 1
    ep = n_devices // dp
    E = 2 * ep
    spec = moe_transformer_classifier(vocab=64, maxlen=16, dim=64, heads=4,
                                      depth=2, num_experts=E, top_k=2,
                                      num_classes=4, dtype=torch.float32)
    losses = _mesh_run(spec, {"dp": dp, "ep": ep} if dp > 1 else {"ep": ep},
                       rng, device, quick, strategy="expert")
    print(f"[ep] MeshTrainer MoE dp={dp}×ep={ep}, {E} experts: "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    return dict(losses=losses)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only",
                    choices=["dp", "tp", "fsdp", "pp", "sp", "ep"],
                    default=None)
    ap.add_argument("--quick", action="store_true",
                    help="half rows/epochs (CI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--records", default=None, metavar="PATH",
                    help="rank 0 writes the demos' records (losses, "
                         "accuracy) to PATH as JSON")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    device = resolve_device(args.device)
    if "DISTKERAS_COORDINATOR" in os.environ and not dist.is_initialized():
        from distkeras_tpu_torch.job_deployment import initialize_cluster

        device = torch.device(initialize_cluster(device=device.type)
                              ["device"])
    n = dist.get_world_size() if dist.is_initialized() else 1
    print(f"devices: {n} × {device.type}")
    rng = np.random.default_rng(0)
    q = args.quick
    demos = {
        "dp": lambda: demo_dp(n, device, q),
        "tp": lambda: demo_tp(n, rng, device, q),
        "fsdp": lambda: demo_fsdp(n, rng, device, q),
        "pp": lambda: demo_pp(n, rng, device, q),
        "sp": lambda: demo_sp(n, rng, device, q),
        "ep": lambda: demo_ep(n, rng, device, q),
    }
    recs = {name: fn() for name, fn in demos.items()
            if args.only in (None, name)}
    if args.records and (not dist.is_initialized() or dist.get_rank() == 0):
        with open(args.records, "w") as f:
            json.dump(recs, f)
    return recs


if __name__ == "__main__":
    main()
