"""Trainer-level strategy seams for pipeline, sequence and expert
parallelism. Port of ``distkeras_tpu/parallel/strategies.py``.

Each strategy is expressed as the pieces
:class:`~distkeras_tpu_torch.parallel.tensor.SPMDEngine` consumes:

- a ``loss_step(params, nt, batch) -> (loss, new_nt)`` whose forward runs
  the strategy's collectives (the GPipe schedule, the ring, the
  all-to-all MoE) on this rank's rows;
- ``specs_for(engine_params)``: the layout the strategy wants (stages over
  ``pp``, replicated for SP, experts over ``ep``);
- ``to_engine`` / ``from_engine``: for pipeline, the ``blocks.i.…``
  leaves stacked onto a leading ``[S]`` axis under ``stages.…`` (each rank
  stores only its stage), and unstacked again for the returned model.

``MeshTrainer(strategy=...)`` wires these into the engine loop, so
checkpointing, EMA, metrics and both input paths work for every strategy.
Trees are the port's flat ``{name: tensor}`` dicts.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.parallel import mesh as mesh_mod
from distkeras_tpu_torch.parallel.pipeline import (
    pipeline_forward,
    stack_stage_params,
)

_STAGES = "stages."


def _split_batch(batch):
    """``(*features, label)`` → (tokens, mask, label); mask defaults to
    ones. The strategies train the transformer families, whose feature
    columns are ``(tokens,)`` or ``(tokens, mask)``."""
    if len(batch) not in (2, 3):
        raise ValueError(
            f"pipeline/sequence/expert strategies take features_col="
            f"['tokens'] or ['tokens', 'mask']; got {len(batch) - 1} "
            f"feature columns")
    toks = batch[0]
    mask = batch[1] if len(batch) == 3 else torch.ones(
        toks.shape, dtype=torch.float32, device=toks.device)
    return toks, mask, batch[-1]


def _require_module(spec, strategy: str, cls):
    module = getattr(spec, "module", None)
    if module is None or not isinstance(module, cls):
        raise TypeError(
            f"strategy={strategy!r} needs a ModelSpec built by from_module "
            f"around a {cls.__name__} (got "
            f"{type(module).__name__ if module is not None else 'no module'}"
            f"); use distkeras_tpu_torch.models."
            f"{'moe_transformer_classifier' if strategy == 'expert' else 'transformer_classifier'}(...)")
    return module


# -- pipeline (GPipe over 'pp', optionally × dp) -----------------------------

def split_pipeline_params(params: dict, depth: int) -> dict:
    """Model params → engine layout: every ``blocks.i.<leaf>`` stacked
    into ``stages.<leaf> [S, …]``; the rest unchanged."""
    stages = []
    for i in range(depth):
        prefix = f"blocks.{i}."
        stage = {k[len(prefix):]: v for k, v in params.items()
                 if k.startswith(prefix)}
        if not stage:
            raise ValueError(
                f"params lack pipeline stage blocks.{i}; strategy="
                f"'pipeline' needs the TransformerClassifier block layout")
        stages.append(stage)
    out = {_STAGES + k: v for k, v in stack_stage_params(stages).items()}
    out.update({k: v for k, v in params.items()
                if not k.startswith("blocks.")})
    return out


def join_pipeline_params(split: dict, depth: int) -> dict:
    """Engine layout → model params (host side, for the trained result)."""
    params = {k: v for k, v in split.items() if not k.startswith(_STAGES)}
    for k, v in split.items():
        if k.startswith(_STAGES):
            for i in range(depth):
                params[f"blocks.{i}.{k[len(_STAGES):]}"] = v[i]
    return params


def pipeline_strategy(spec, loss_fn, mesh, *, pp_axis: str = "pp",
                      microbatches: int | None = None):
    """``(loss_step, specs_for, to_engine, from_engine)`` for GPipe: stage
    leaves ``[S, …]`` split over ``pp`` (one block a rank), the embedding
    and head replicated (their gradients are this rank's parts, summed
    over ``pp`` by the engine)."""
    from distkeras_tpu_torch.models.transformer import TransformerClassifier

    module = _require_module(spec, "pipeline", TransformerClassifier)
    S = mesh.size(pp_axis)
    if module.depth != S:
        raise ValueError(
            f"model depth {module.depth} != mesh axis '{pp_axis}' size {S} "
            f"(one encoder block per stage)")
    depth, group = module.depth, mesh.group(pp_axis)
    M = int(microbatches) if microbatches else S

    def loss_step(params, nt, batch):
        toks, mask, y = _split_batch(batch)
        stage = {k[len(_STAGES):]: v[0] for k, v in params.items()
                 if k.startswith(_STAGES)}
        rest = {k: v for k, v in params.items() if not k.startswith(_STAGES)}
        logits = pipeline_forward(module, stage, {**rest, **nt}, toks, mask,
                                  group, M)
        return loss_fn(y, logits), nt

    def specs_for(eparams):
        return {k: ((pp_axis,) if k.startswith(_STAGES) else ())
                for k in eparams}

    return (loss_step, specs_for,
            lambda p: split_pipeline_params(p, depth),
            lambda p: join_pipeline_params(p, depth))


# -- sequence (ring attention over 'sp', optionally × dp) --------------------

def sequence_strategy(spec, loss_fn, mesh, *, sp_axis: str = "sp"):
    """The SP pieces: activations split along L, ring attention, params
    replicated (their gradients come back whole on every rank)."""
    from distkeras_tpu_torch.models.transformer import (
        TransformerClassifier,
        sequence_parallel_transformer_forward,
    )

    module = _require_module(spec, "sequence", TransformerClassifier)

    def loss_step(params, nt, batch):
        toks, mask, y = _split_batch(batch)
        logits = sequence_parallel_transformer_forward(
            module, {**params, **nt}, toks, mask, mesh, axis=sp_axis)
        return loss_fn(y, logits), nt

    def specs_for(eparams):
        return {k: () for k in eparams}

    ident = lambda p: p
    return loss_step, specs_for, ident, ident


# -- expert (GShard MoE over 'ep') -------------------------------------------

def expert_specs(params: dict, ep_axis: str = "ep") -> dict:
    """Expert-stacked leaves (``w1/b1/w2/b2``, leading ``[E]``) split over
    ``ep``; the gate, attention and embed/head replicated."""
    return {k: ((ep_axis,) if k.rsplit(".", 1)[-1] in ("w1", "b1", "w2", "b2")
                else ()) for k in params}


def expert_strategy(spec, loss_fn, mesh, *, ep_axis: str = "ep",
                    aux_weight: float = 1e-2):
    """The EP pieces: experts split over ``ep``, tokens exchanged with
    ``all_to_all``, the gating aux loss (weight ``aux_weight``) in the
    objective."""
    from distkeras_tpu_torch.models.moe import (
        MoETransformerClassifier,
        moe_aux_loss,
    )

    module = _require_module(spec, "expert", MoETransformerClassifier)
    if module.num_experts % mesh.size(ep_axis):
        raise ValueError(
            f"{module.num_experts} experts not divisible by mesh axis "
            f"'{ep_axis}' of size {mesh.size(ep_axis)}")
    ctx = mesh_mod.MeshContext(ep_group=mesh.group(ep_axis))

    def loss_step(params, nt, batch):
        toks, mask, y = _split_batch(batch)
        with mesh_mod.using(ctx):
            logits, aux = moe_aux_loss(module, {**params, **nt},
                                       (toks, mask))
        return loss_fn(y, logits) + aux_weight * aux, nt

    def specs_for(eparams):
        return expert_specs(eparams, ep_axis)

    ident = lambda p: p
    return loss_step, specs_for, ident, ident


STRATEGIES = {
    "pipeline": pipeline_strategy,
    "sequence": sequence_strategy,
    "expert": expert_strategy,
}

#: the axes over which each strategy's replicated leaves carry partial
#: gradients (the engine's ``sum_axes``)
SUM_AXES = {"pipeline": ("pp",), "sequence": (), "expert": ()}

__all__ = ["STRATEGIES", "SUM_AXES", "expert_specs", "expert_strategy",
           "join_pipeline_params", "pipeline_strategy", "sequence_strategy",
           "split_pipeline_params"]
