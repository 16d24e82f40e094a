"""Long-context training tour on the port: flash attention, remat and
sequence parallelism. The twin of ``examples/longcontext.py``, on the card
unless ``--device cpu`` asks for the CPU. Two legs:

1. **flash attention + rematerialization** — one fwd+bwd+Adam step of the
   encoder classifier at long L with ``remat=True``: on the card in bf16
   through the flash kernels (the forward twice a block, once in the
   forward pass and once in the backward's recompute; dq and dk/dv once),
   on the CPU in f32 through plain attention.
2. **sequence parallelism** — the classifier's forward and gradient with
   activations split along L over the ``"sp"`` axis of the world
   (``sequence_parallel_transformer_forward``, ring attention): one rank
   unless the script runs as a world (``job_deployment.Job`` sets the
   ``DISTKERAS_*`` environment ``initialize_cluster`` reads).

Run:  python -m distkeras_tpu_torch.examples.longcontext
      python -m distkeras_tpu_torch.examples.longcontext --device cpu --quick
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from distkeras_tpu_torch.ops.losses import sparse_softmax_cross_entropy
from distkeras_tpu_torch.utils import resolve_device


def loss_and_grads(spec, params, nt, toks, mask, y):
    """The example's loss, ``sparse_softmax_cross_entropy`` of the
    training-mode forward, and its gradients: ``(loss, grads, new_nt)``."""
    def loss_fn(p):
        out, new_nt = spec.apply(p, nt, (toks, mask), True)
        return sparse_softmax_cross_entropy(y, out), new_nt

    grads, (loss, nt2) = torch.func.grad_and_value(loss_fn, has_aux=True)(
        params)
    return loss, grads, nt2


def train_step_fn(spec, lr: float = 1e-3):
    """``(make_opt, step)``: ``make_opt(params)`` is ``torch.optim.Adam``
    over the param dict's tensors; ``step(params, opt, nt, toks, mask, y)
    -> (params, opt, nt, loss)`` takes one step in place, as the JAX
    example's jitted optax step does on its donated buffers."""
    def make_opt(params):
        return torch.optim.Adam(list(params.values()), lr=lr)

    def step(params, opt, nt, toks, mask, y):
        loss, grads, nt2 = loss_and_grads(spec, params, nt, toks, mask, y)
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        opt.zero_grad(set_to_none=True)
        return params, opt, nt2, loss.detach()

    return make_opt, step


def flash_remat_setup(quick: bool, device):
    """The first leg's model, params, state and batch: ``(spec, dims, L,
    B, impl, params, nt, (toks, mask, y))``, tensors on ``device``."""
    from distkeras_tpu_torch.models import transformer_classifier

    on_card = device.type == "cuda"
    L = 512 if quick else 4096
    B = 2 if quick else 8
    dims = dict(dim=64, heads=4, depth=2) if quick else \
        dict(dim=512, heads=8, depth=8)
    impl = "flash" if on_card else "reference"
    spec = transformer_classifier(
        vocab=1000, maxlen=L, num_classes=4, attn_impl=impl,
        dtype=torch.bfloat16 if on_card else torch.float32, remat=True,
        **dims)
    params, nt = spec.init(0)
    params = {k: v.to(device) for k, v in params.items()}
    nt = {k: v.to(device) for k, v in nt.items()}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    y = rng.integers(0, 4, size=(B,)).astype(np.int32)
    batch = tuple(torch.from_numpy(a).to(device) for a in (toks, mask, y))
    return spec, dims, L, B, impl, params, nt, batch


def demo_flash_and_remat(quick: bool, device) -> dict:
    """One full training step at long L with the memory levers on."""
    spec, dims, L, B, impl, params, nt, batch = flash_remat_setup(
        quick, device)
    make_opt, step = train_step_fn(spec)
    opt = make_opt(params)
    params, opt, nt, loss = step(params, opt, nt, *batch)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"[flash+remat] the step's loss is {loss}")
    print(f"[flash+remat] L={L} B={B} {dims} attn={impl}: one fwd+bwd+adam "
          f"step OK, loss={loss:.4f}")
    return dict(L=L, B=B, attn=impl, loss=loss, **dims)


def sp_loss_and_grad_norm(module, params, toks, mask, mesh):
    """``mean(logits²)`` of the sequence-parallel forward over ``mesh``'s
    ``"sp"`` axis and the squared norm of its gradients: ``(loss, grad
    norm²)``."""
    from distkeras_tpu_torch.models.transformer import (
        sequence_parallel_transformer_forward,
    )

    def loss(p):
        lg = sequence_parallel_transformer_forward(module, p, toks, mask,
                                                   mesh)
        return torch.mean(lg ** 2)

    grads, val = torch.func.grad_and_value(loss)(params)
    gn = sum(float(torch.sum(g.double() ** 2)) for g in grads.values())
    return float(val), gn


def demo_sequence_parallel(quick: bool, device) -> dict:
    """Model-level SP: forward+grad with activations sharded along L."""
    import torch.distributed as dist

    from distkeras_tpu_torch.models.transformer import TransformerClassifier
    from distkeras_tpu_torch.parallel.mesh import get_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    L = 16 * n if quick else 256 * n
    module = TransformerClassifier(vocab=1000, maxlen=L, dim=64, heads=4,
                                   depth=2, num_classes=4,
                                   dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module.reset_parameters(gen)
    module = module.to(device)
    params = {k: v.detach() for k, v in module.named_parameters()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, 1000, size=(2, L)).astype(np.int64)).to(device)
    mask = torch.ones((2, L), dtype=torch.float32, device=device)
    with get_mesh(n, device=device, axis="sp") as mesh:
        val, gn = sp_loss_and_grad_norm(module, params, toks, mask, mesh)
    print(f"[sp] L={L} sharded over {n} rank(s): fwd+bwd OK, "
          f"loss={val:.4f}, grad norm²={gn:.3e} — per-rank "
          f"activations hold L/N={L // n} positions")
    return dict(L=L, ranks=n, loss=val, grad_norm2=gn)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized shapes (small L, tiny model)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    device = resolve_device(args.device)
    if "DISTKERAS_COORDINATOR" in os.environ and not dist.is_initialized():
        from distkeras_tpu_torch.job_deployment import initialize_cluster

        device = torch.device(initialize_cluster(device=device.type)
                              ["device"])
    print(f"device: {device}")
    return {"flash_remat": demo_flash_and_remat(args.quick, device),
            "sp": demo_sequence_parallel(args.quick, device)}


if __name__ == "__main__":
    main()
