"""Pipeline parallelism: GPipe over a mesh axis. Port of
``distkeras_tpu/parallel/pipeline.py``.

One stage a rank. Every rank runs the same microbatch loop: the first
stage reads microbatch ``m``, every stage applies its block and sends the
activation to the next stage with a point-to-point send, and the last
stage collects the finished microbatches. The backward runs the reverse
schedule through autograd: each send and receive is an
``autograd.Function`` whose backward receives or sends the activation's
gradient, and a scalar token threaded through them fixes the order
(microbatch ``M-1`` first on every rank), so the ranks' sends and
receives always pair up. JAX derives the same reverse schedule by
transposing ``ppermute`` inside its scan.

Activations are tuples of floating tensors (``(hidden, mask)``); every
stage must keep their shapes. Every rank holds the whole input (the
multi-controller convention), so each knows the shapes it receives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distkeras_tpu_torch.parallel import mesh as mesh_mod


class _Recv(torch.autograd.Function):
    """Forward: receive an activation from ``src``; backward: send its
    gradient back. Returns the activation's tensors and a new token."""

    @staticmethod
    def forward(token, src, group, tag, *like):
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in like]
        for o in outs:
            dist.recv(o, src, group=group, tag=tag)
        return (*outs, token.new_zeros(()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.src, ctx.group, ctx.tag = inputs[1], inputs[2], inputs[3]
        ctx.like = [(t.shape, t.dtype) for t in inputs[4:]]
        ctx.token = (inputs[0].shape, inputs[0].dtype, inputs[0].device)

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.token
        for g, (s, dt) in zip(grads[:-1], ctx.like):
            g = torch.zeros(s, dtype=dt, device=device) if g is None \
                else g.contiguous()
            dist.send(g, ctx.src, group=ctx.group, tag=ctx.tag)
        return (torch.zeros(shape, dtype=dtype, device=device), None, None,
                None) + (None,) * len(ctx.like)


class _Send(torch.autograd.Function):
    """Forward: send an activation to ``dst``; backward: receive its
    gradient. Returns a new token."""

    @staticmethod
    def forward(token, dst, group, tag, *ys):
        for y in ys:
            dist.send(y.contiguous(), dst, group=group, tag=tag)
        return token.new_zeros(())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dst, ctx.group, ctx.tag = inputs[1], inputs[2], inputs[3]
        ctx.like = [(t.shape, t.dtype, t.device) for t in inputs[4:]]

    @staticmethod
    def backward(ctx, g_token):
        grads = []
        for s, dt, dev in ctx.like:
            g = torch.empty(s, dtype=dt, device=dev)
            dist.recv(g, ctx.dst, group=ctx.group, tag=ctx.tag)
            grads.append(g)
        return (torch.zeros_like(g_token), None, None, None, *grads)


class _FromLast(torch.autograd.Function):
    """Broadcast the last stage's value to every rank of the pipeline;
    the backward keeps the last stage's own cotangent (every rank runs the
    same downstream) and hands the other ranks' tokens a zero."""

    @staticmethod
    def forward(value, group, src, is_src, shape, dtype):
        out = value.clone() if is_src else torch.empty(
            shape, dtype=dtype, device=value.device)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.is_src = inputs[3]
        ctx.value = (inputs[0].shape, inputs[0].dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.is_src:
            return g, None, None, None, None, None
        shape, dtype = ctx.value
        return (torch.zeros(shape, dtype=dtype, device=g.device), None, None,
                None, None, None)


def run_pipeline(stage_fn, stage_params, x_mbs: list, group, finish):
    """The GPipe loop on this rank: ``stage_fn(stage_params, act) -> act``
    over the microbatch activations ``x_mbs`` (tuples, every rank holding
    them), then ``finish(acts)`` on the last stage over the concatenated
    outputs, its tuple of tensors broadcast to every rank of ``group``."""
    S = mesh_mod._gsize(group)
    p = dist.get_rank(group) if group is not None else 0
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else [0]
    dev = x_mbs[0][0].device
    token = torch.zeros((), device=dev, requires_grad=True)
    outs = []
    for m, xm in enumerate(x_mbs):
        if p == 0:
            act = tuple(xm)
        else:
            *act, token = _Recv.apply(token, ranks[p - 1], group, m, *xm)
            act = tuple(act)
        y = tuple(stage_fn(stage_params, act))
        if p < S - 1:
            token = _Send.apply(token, ranks[p + 1], group, m, *y)
        else:
            outs.append(y)
    result = None
    if p == S - 1:
        result = tuple(finish(tuple(torch.cat(parts, 0)
                                    for parts in zip(*outs))))
    if S == 1:
        return result
    meta = [None if result is None else [(tuple(r.shape), r.dtype)
                                         for r in result]]
    dist.broadcast_object_list(meta, ranks[-1], group=group)
    is_src = p == S - 1
    return tuple(
        _FromLast.apply(result[i] if is_src else token, group, ranks[-1],
                        is_src, shape, dtype)
        for i, (shape, dtype) in enumerate(meta[0]))


def _microbatches(xs: tuple, M: int) -> list:
    B = xs[0].shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    return [tuple(t[i * mb:(i + 1) * mb] for t in xs) for i in range(M)]


def pipeline_apply(stage_fn, stage_params: dict, x, mesh, axis: str = "pp",
                   microbatches: int | None = None,
                   batch_axis: str | None = None):
    """Apply ``S`` chained stages to ``x`` pipelined over mesh axis
    ``axis``: ``stage_fn(params_i, act) -> act`` keeps the activation's
    structure and shapes; ``stage_params`` leaves are ``[S, …]`` (every
    rank passes all of them; each takes its own stage); ``x`` is a tensor
    or a tuple of tensors ``[B, …]`` with ``B % microbatches == 0``
    (default ``microbatches = S``). ``batch_axis`` composes data
    parallelism: each rank takes its rows of that axis first. Returns the
    output (a tensor or tuple, as ``x``) on every rank, equal to
    :func:`sequential_apply`. The stage parameters' gradients come back
    whole on every rank; ``x``'s on the first stage's ranks. Take them
    with ``backward()`` on every rank: ``torch.autograd.grad`` with
    explicit inputs prunes the receives that lie on no path to them, and
    their gradient sends never happen."""
    S = mesh.size(axis)
    M = int(microbatches) if microbatches else S
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    for v in stage_params.values():
        if v.shape[0] != S:
            raise ValueError(f"stage_params leading axis {v.shape[0]} != "
                             f"mesh axis '{axis}' size {S}")
        break
    if xs[0].shape[0] % M:
        raise ValueError(f"batch {xs[0].shape[0]} not divisible by {M} "
                         f"microbatches")
    if batch_axis is not None:
        if batch_axis not in mesh.shape:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        n, i = mesh.size(batch_axis), mesh.index(batch_axis)
        mb = xs[0].shape[0] // M
        if mb % n:
            raise ValueError(f"microbatch rows {mb} not divisible by mesh "
                             f"axis '{batch_axis}' of size {n}")
        rows = xs[0].shape[0] // n
        xs = tuple(t[i * rows:(i + 1) * rows] for t in xs)
    g = mesh.group(axis)
    mine = {k: mesh_mod.split_to(v, g, 0)[0] for k, v in stage_params.items()}
    out = run_pipeline(stage_fn, mine, _microbatches(xs, M), g,
                       lambda acts: acts)
    return out[0] if single else out


def pipeline_forward(module, stage_params: dict, params: dict, tokens, mask,
                     group, microbatches: int):
    """The transformer classifier through :func:`run_pipeline`: the
    embedding (read by the first stage), this rank's block
    (``stage_params``, names relative to the block) as its stage, and the
    head on the last stage; returns the logits on every rank."""
    from distkeras_tpu_torch.models.transformer import EncoderBlock

    full = {**{k: b.to(tokens.device) for k, b in module.named_buffers()},
            **params}
    x = torch.func.functional_call(module, full, (tokens,),
                                   {"method": "embed_tokens"})
    impl = "reference" if module.attn_impl == "ring" else module.attn_impl
    block = EncoderBlock(module.dim, module.heads, causal=module.causal,
                         dtype=module.dtype, attn_impl=impl,
                         attn_window=module.attn_window)

    def stage(p, act):
        h, m = act
        return torch.func.functional_call(block, p, (h, m)), m

    def finish(acts):
        h, m = acts
        return (torch.func.functional_call(module, full, (h, m),
                                           {"method": "head_logits"}),)

    mask = mask.to(torch.float32)
    out = run_pipeline(stage, stage_params,
                       _microbatches((x, mask), int(microbatches)), group,
                       finish)
    return out[0]


def stack_stage_params(per_stage: list) -> dict:
    """Stack per-stage ``{name: tensor}`` trees into the leading-``[S]``
    layout :func:`pipeline_apply` takes."""
    return {k: torch.stack([torch.as_tensor(p[k]) for p in per_stage])
            for k in per_stage[0]}


def sequential_apply(stage_fn, stage_params: dict, x):
    """The single-device oracle: the stages chained in order."""
    S = next(iter(stage_params.values())).shape[0]
    for i in range(S):
        x = stage_fn({k: v[i] for k, v in stage_params.items()}, x)
    return x


__all__ = ["pipeline_apply", "pipeline_forward", "run_pipeline",
           "sequential_apply", "stack_stage_params"]
