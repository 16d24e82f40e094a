"""Mixture-of-experts transformer classifier. Port of
``distkeras_tpu/models/moe.py``.

Encoder blocks whose feed-forward is the GShard-style MoE layer of
:mod:`distkeras_tpu_torch.parallel.expert`: on one device
(``moe_mlp_reference``), or expert-parallel over an ``ep`` axis
(``moe_mlp_shard``) while an expert-parallel context is active, which
``moe_transformer_classifier(mesh=...)`` and ``MeshTrainer(strategy=
"expert")`` set around the forward.

The gating auxiliary (load-balancing) loss: flax ``sow``s it into a
``moe_aux`` collection, but a forward under ``torch.func.vmap`` cannot
keep a tensor on its module. So the forward returns it when asked
(``return_aux=True``: ``(logits, mean aux over the blocks)``), and
:func:`moe_aux_loss` runs that forward on the module and a state dict of
params.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import Dense, Embed
from distkeras_tpu_torch.models.transformer import (
    LayerNorm,
    attention_sublayer,
    sincos_positions,
)
from distkeras_tpu_torch.parallel import mesh as mesh_mod
from distkeras_tpu_torch.parallel.expert import (
    moe_mlp_reference,
    moe_mlp_shard,
)


class MoEEncoderBlock(nn.Module):
    """Pre-norm attention sublayer (on the "reference" path, as the JAX
    block), then ``ln_moe`` and the MoE MLP over all ``B·L`` tokens of the
    batch, with a residual. ``forward(x, mask) -> (x, aux)``. Parameters
    carry flax's names: ``ln_attn``, ``qkv``, ``attn_out``, ``ln_moe``,
    and the bare ``gate [D, E]``, ``w1 [E, D, Hd]``, ``b1``, ``w2 [E, Hd,
    D]``, ``b2``."""

    def __init__(self, dim: int, heads: int, num_experts: int = 8,
                 top_k: int = 2, mlp_ratio: int = 4,
                 capacity_factor: float = 2.0, causal: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.top_k, self.capacity_factor = top_k, capacity_factor
        E, D, Hd = num_experts, dim, mlp_ratio * dim
        self.ln_attn = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, dtype, parallel="column")
        self.attn_out = Dense(dim, dim, dtype, parallel="row")
        self.ln_moe = LayerNorm(dim)
        self.gate = nn.Parameter(torch.empty((D, E)))
        self.w1 = nn.Parameter(torch.empty((E, D, Hd)))
        self.b1 = nn.Parameter(torch.zeros((E, Hd)))
        self.w2 = nn.Parameter(torch.empty((E, Hd, D)))
        self.b2 = nn.Parameter(torch.zeros((E, D)))

    def reset_parameters(self, generator) -> None:
        for mod in (self.ln_attn, self.qkv, self.attn_out, self.ln_moe):
            mod.reset_parameters(generator)
        for w in (self.gate, self.w1, self.w2):
            w.normal_(0.0, 0.02, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x, mask=None):
        B, L, D = x.shape
        x = attention_sublayer(x, mask, self.ln_attn, self.qkv,
                               self.attn_out, heads=self.heads,
                               causal=self.causal)
        h = self.ln_moe(x)
        params = {"gate": self.gate, "w1": self.w1, "b1": self.b1,
                  "w2": self.w2, "b2": self.b2}
        tokens = h.reshape(B * L, D).to(torch.float32)
        ep = mesh_mod.context().ep_group
        if ep is not None:
            y, aux = moe_mlp_shard(params, tokens, ep, top_k=self.top_k,
                                   capacity_factor=self.capacity_factor)
        else:
            y, aux = moe_mlp_reference(
                params, tokens, top_k=self.top_k,
                capacity_factor=self.capacity_factor)
        return x + y.reshape(B, L, D), aux


class MoETransformerClassifier(nn.Module):
    """``(tokens [B, L], mask [B, L]) → logits [B, num_classes]`` (f32)
    with MoE feed-forwards. Parameters carry flax's names: ``embed``,
    ``block_{i}``, ``ln_head``, ``head``."""

    def __init__(self, vocab: int = 20000, maxlen: int = 200, dim: int = 128,
                 heads: int = 4, depth: int = 2, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 num_classes: int = 2, causal: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.depth, self.num_experts = depth, num_experts
        self.embed = Embed(vocab, dim, dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", MoEEncoderBlock(
                dim, heads, num_experts=num_experts, top_k=top_k,
                capacity_factor=capacity_factor, causal=causal, dtype=dtype))
        self.ln_head = LayerNorm(dim)
        self.head = Dense(dim, num_classes, dtype)
        self.register_buffer("pos_table", torch.from_numpy(
            sincos_positions(maxlen, dim)), persistent=False)

    def reset_parameters(self, generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, tokens, mask=None, return_aux: bool = False):
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        x = self.embed(tokens).to(torch.float32)
        x = x + self.pos_table[:tokens.shape[1]][None]
        auxes = []
        for i in range(self.depth):
            x, aux = getattr(self, f"block_{i}")(x, mask)
            auxes.append(aux)
        m = mask.to(torch.float32)[..., None]
        pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
        logits = self.head(self.ln_head(pooled)).to(torch.float32)
        if return_aux:
            return logits, torch.mean(torch.stack(auxes))
        return logits


def moe_aux_loss(module: MoETransformerClassifier, params: dict, inputs,
                 training: bool = True):
    """Run the model collecting the gating auxiliary loss: ``params`` is
    the ``{name: tensor}`` state dict a ``ModelSpec`` trains (or ``None``
    for the module's own), ``inputs`` the ``(tokens, mask)`` tuple.
    Returns ``(logits, aux)``, ``aux`` the mean of the blocks'
    load-balancing losses: add ``aux_weight * aux`` to the objective.
    ``training`` is accepted for the JAX signature; the model has no
    training-only layer."""
    del training
    inputs = inputs if isinstance(inputs, tuple) else (inputs,)
    if params is None:
        return module(*inputs, return_aux=True)
    return torch.func.functional_call(module, params, inputs,
                                      {"return_aux": True})


def moe_transformer_classifier(vocab=20000, maxlen=200, dim=128, heads=4,
                               depth=2, num_experts=8, top_k=2,
                               capacity_factor=2.0, num_classes=2,
                               causal=False, dtype=torch.bfloat16,
                               mesh=None, ep_axis="ep") -> ModelSpec:
    """The MoE classifier as a ``ModelSpec``: features ``(tokens, mask)``
    (``features_col=["features", "mask"]``), f32 master params. With
    ``mesh`` its apply runs the MoE layers expert-parallel over
    ``ep_axis``: every rank passes the whole params and batch, routes its
    slice of the tokens and computes with its ``E/N`` experts (sliced from
    the whole ``[E, …]`` leaves); the logits are the same on every
    rank."""
    module = MoETransformerClassifier(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
        num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor, num_classes=num_classes,
        causal=causal, dtype=dtype)
    example = (torch.zeros((1, maxlen), dtype=torch.int64),
               torch.ones((1, maxlen), dtype=torch.float32))
    spec = from_module(module, name="moe_transformer_classifier",
                       example=example)
    if mesh is None:
        return spec
    if num_experts % mesh.size(ep_axis):
        raise ValueError(f"{num_experts} experts not divisible by mesh "
                         f"axis '{ep_axis}' of size {mesh.size(ep_axis)}")
    group, inner = mesh.group(ep_axis), spec.apply

    def apply(params, state, x, training):
        params = {k: (mesh_mod.split_to(v, group, 0)
                      if k.rsplit(".", 1)[-1] in _EXPERT_LEAVES else v)
                  for k, v in params.items()}
        with mesh_mod.using(mesh_mod.MeshContext(ep_group=group)):
            return inner(params, state, x, training)

    return dataclasses.replace(spec, apply=apply)


#: the expert-stacked leaves (``[E, …]``) of a MoE block
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")
