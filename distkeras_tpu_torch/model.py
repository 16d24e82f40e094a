"""ModelSpec — the functional model contract the training engine consumes.

Port of ``distkeras_tpu/model.py``. The engine stacks every worker's
parameters on a leading ``W`` axis and runs the model under
``torch.func.vmap``, so the model must be a pure function of explicit
state:

- ``init(seed) -> (params, state)``: trainable params and non-trainable
  state, each a dict ``{state_dict name: tensor}`` on the CPU (the engine
  places them); ``state`` is ``{}`` for the stateless zoo;
- ``apply(params, state, x, training) -> (outputs, new_state)``: pure, and
  traceable by ``torch.func`` transforms.

A module that owns non-trainable state (``ResNetSmall``'s BatchNorm
statistics) sets ``returns_state = True``: its pure forward takes
``training`` and returns ``(out, new_state)``, the new state keyed by the
module's buffer names, which ``apply`` merges over the state it was given
(flax's ``mutable=["batch_stats"]`` seam in the JAX package).

:func:`from_module` wraps an ``nn.Module`` through
``torch.func.functional_call``: the module is a stateless template whose
own tensors are never read once params are supplied. A tuple ``x`` unpacks
into several inputs (the LSTM takes ``(tokens, mask)``).
``functional_call`` swaps the supplied tensors into the module for the
call, so threads that apply one spec at the same time (the parameter-server
backend's workers) each get their own copy of the template.

:func:`from_keras` wraps a built Keras 3 model on Keras's torch backend
through ``model.stateless_call``, so the reference's contract, "hand a
Keras model to a trainer", holds on the port too. Keras is imported only
when a Keras model is wrapped: the package never needs it otherwise.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Any, Callable

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    init: Callable[[int], tuple[dict, dict]]
    apply: Callable[[dict, dict, Any, bool], tuple[Any, dict]]
    name: str = "model"
    #: the training-mode apply averages over the collective backend's
    #: stacked-worker vmap dimension (sync BatchNorm through
    #: ``parallel.local_sgd.worker_mean``), so it cannot train on the PS
    #: backend's independent host threads
    requires_worker_axis: bool = False
    #: the template ``nn.Module`` when built by :func:`from_module`; the
    #: weight bridge (``convert``) reads its layer types and shapes
    module: Any = None
    #: an example input (a tensor, or a tuple of them for several inputs)
    #: of batch 1 on the CPU, where the zoo records one: what
    #: ``ops.quant.quantize_serving`` runs one forward on to find the
    #: layers the serving forward reaches; ``None`` when unknown
    example: Any = None
    #: optional fused loss implementations, keyed by the trainer-facing loss
    #: name: ``{name: fn(params, state, x, y, training, mask=None) -> (loss,
    #: new_state)}``. A trainer built with ``loss=<name>`` calls the fused fn
    #: instead of ``loss(y, apply(x))``: the model computes its own loss
    #: without materialising its full output (the LM's chunked
    #: cross-entropy never builds the ``[B, L, V]`` logits).
    fused_losses: Any = None

    def init_np(self, seed: int = 0) -> tuple[dict, dict]:
        """Host-side init returning numpy dicts."""
        params, state = self.init(seed)
        to_np = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}
        return to_np(params), to_np(state)


def per_thread(template: nn.Module):
    """A callable returning the module to hand ``functional_call`` in the
    calling thread: ``template`` itself in the main thread, a copy of it
    made on first use in any other."""
    local = threading.local()

    def module_here() -> nn.Module:
        mod = getattr(local, "module", None)
        if mod is None:
            mod = local.module = (
                template if threading.current_thread()
                is threading.main_thread() else copy.deepcopy(template))
        return mod

    return module_here


def from_module(module: nn.Module, *, name: str | None = None,
                example=None) -> ModelSpec:
    """Wrap an ``nn.Module`` whose ``reset_parameters(generator)`` draws
    its initial weights. ``init(seed)`` draws them on the CPU from a
    ``torch.Generator`` seeded with ``seed``; buffers are the state (a
    module's ``reset_parameters`` sets its own, as BatchNorm's 0 and 1).
    ``example`` is recorded as the spec's example input."""
    template = module

    def init(seed):
        fresh = copy.deepcopy(template).to("cpu")
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            fresh.reset_parameters(gen)
        params = {k: v.detach() for k, v in fresh.named_parameters()}
        state = {k: v.detach() for k, v in fresh.named_buffers()}
        return params, state

    module_here = per_thread(template)
    stateful = getattr(module, "returns_state", False)

    def apply(params, state, x, training):
        inputs = x if isinstance(x, tuple) else (x,)
        if not stateful:
            out = torch.func.functional_call(
                module_here(), {**params, **state}, inputs)
            return out, state
        out, new_state = torch.func.functional_call(
            module_here(), {**params, **state}, inputs,
            {"training": bool(training)})
        return out, {**state, **new_state}

    return ModelSpec(init=init, apply=apply,
                     name=name or type(module).__name__, module=module,
                     example=example)


def _keras_keys(variables) -> list[str]:
    """Dict keys for Keras variables: the list index, zero-padded so the
    sorted walk of :func:`utils.flatten` keeps Keras's order, then the
    variable's path."""
    return [f"{i:04d}:{v.path}" for i, v in enumerate(variables)]


def from_keras(model, *, name: str | None = None) -> ModelSpec:
    """Wrap a built Keras 3 model (``KERAS_BACKEND=torch``) via
    ``stateless_call``. Trainable variables become the params,
    non-trainable ones (BatchNorm's moving statistics, a Dropout seed) the
    state, each a dict in the model's variable order (keys from
    :func:`_keras_keys`). ``init`` returns the model's current weights, as
    CPU tensors; ``apply`` runs on the device its params lie on."""
    import keras

    if keras.backend.backend() != "torch":
        raise ValueError(
            f"Keras is running the {keras.backend.backend()!r} backend; "
            f"distkeras_tpu_torch needs KERAS_BACKEND=torch (set the env "
            f"var before importing keras: stateless_call on another "
            f"backend cannot take torch tensors)")
    if not model.built:
        raise ValueError(
            "Keras model must be built (call it once or set input shape)")
    pkeys = _keras_keys(model.trainable_variables)
    skeys = _keras_keys(model.non_trainable_variables)

    def init(seed):
        del seed  # a Keras model arrives initialised: its weights are used
        grab = lambda vs: [v.value.detach().to("cpu", copy=True) for v in vs]
        return (dict(zip(pkeys, grab(model.trainable_variables))),
                dict(zip(skeys, grab(model.non_trainable_variables))))

    def apply(params, state, x, training):
        p = [params[k] for k in pkeys]
        device = p[0].device if p else getattr(x, "device", "cpu")
        # Keras places the tensors it creates on its default device (the
        # card when there is one): pin them to the params' device
        with keras.device(str(device)):
            out, new_state = model.stateless_call(
                p, [state[k] for k in skeys], x, training=training)
        return out, dict(zip(skeys, new_state))

    return ModelSpec(init=init, apply=apply, name=name or model.name)


def keras_weights_to_model(model, params: dict, state: dict) -> None:
    """Write trained params and state (:func:`from_keras`'s dicts) back
    into the live Keras model, in place."""
    for var, key in zip(model.trainable_variables,
                        _keras_keys(model.trainable_variables)):
        var.assign(_host(params[key]))
    for var, key in zip(model.non_trainable_variables,
                        _keras_keys(model.non_trainable_variables)):
        var.assign(_host(state[key]))


def _host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x
