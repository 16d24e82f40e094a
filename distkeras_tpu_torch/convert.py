"""Weight bridge between the JAX package's flax param trees and the port's
modules, both ways.

``params_from_jax(tree, module)`` takes a flax param tree as nested dicts
of numpy arrays — ``spec.init_np(0)``, a trained tree, or ``quantize_lm``'s
int8 tree — and copies it into a port module built with the same
configuration (the serving LM, or a training model's template, e.g.
``spec.module``); :func:`tensors_from_jax` returns the same values as a
``{name: tensor}`` dict without touching the module, the form
``ModelSpec`` params take. ``params_to_jax(params, module)`` is the
reverse: nested dicts of numpy arrays keyed by flax names, with the same
leaf paths as the reference tree.

flax names map one to one onto module attribute names, ``blocks_i`` onto
``blocks.i``. Layouts:

- a Dense ``kernel [in, out]`` is ``weight [out, in]``; an int8
  ``kernel_q [in, out]`` is ``kernel_q [out, in]``, the layout the
  q_matmul kernel streams (``csrc/quant.cu``); ``scale`` and ``bias`` copy
  as they are;
- a conv ``kernel`` HWIO ``[kh, kw, in, out]`` is ``weight`` OIHW;
- a Dense that reads a flattened conv feature map (``nhwc_from = (C, H,
  W)``, LeNet's and VGG's first Dense) has its input rows permuted: flax
  flattens NHWC (``models/cnn.py:31``), the port NCHW;
- an Embed's ``embedding`` is ``weight``, a LayerNorm's ``scale`` is
  ``weight``;
- a bare-array leaf (the LSTM's ``wh``, the MoE block's ``gate`` and
  expert weights) is a bare ``nn.Parameter`` of the same name and layout;
- a BatchNorm's ``scale`` is ``weight``, as a LayerNorm's; its
  ``batch_stats`` (``mean``, ``var``) are the module's state buffers of
  the same names, which :func:`state_from_jax` / :func:`state_to_jax` map
  and the param functions leave out.

Every destination tensor must be written exactly once, at its own shape,
or the bridge raises. Values are cast to the destination's dtype (f32 →
bf16 rounds to nearest even, as ``astype``); ``params_to_jax`` widens bf16
to f32 (exact).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.layers import BatchNorm, Embed


def _part(key: str) -> str:
    if key.startswith("blocks_") and key[7:].isdigit():
        return f"blocks.{key[7:]}"
    return key


def _flax_parts(module_path: str) -> list[str]:
    parts = module_path.split(".") if module_path else []
    out = []
    for p in parts:
        if p.isdigit() and out and out[-1] == "blocks":
            out[-1] = f"blocks_{p}"
        else:
            out.append(p)
    return out


def _nhwc_rows_to_nchw(kernel, chw):
    """flax kernel [H*W*C, N] (rows h, w, c) → torch weight [N, C*H*W]."""
    c, h, w = chw
    n = kernel.shape[1]
    return kernel.reshape(h, w, c, n).transpose(2, 0, 1, 3).reshape(
        c * h * w, n).T


def _nchw_cols_to_nhwc(weight, chw):
    """torch weight [N, C*H*W] → flax kernel [H*W*C, N]."""
    c, h, w = chw
    n = weight.shape[0]
    return weight.T.reshape(c, h, w, n).transpose(1, 2, 0, 3).reshape(
        h * w * c, n)


def _leaves(node, path, module):
    """(torch name, array) pairs for one flax subtree."""
    prefix = ".".join(path)
    if not isinstance(node, Mapping):
        yield prefix, np.asarray(node)             # bare parameter
        return
    keys = set(node)
    if "kernel_q" in keys:                       # QDense
        yield f"{prefix}.kernel_q", np.asarray(node["kernel_q"]).T
        yield f"{prefix}.scale", np.asarray(node["scale"])
        if "bias" in node:
            yield f"{prefix}.bias", np.asarray(node["bias"])
    elif "kernel" in keys:                       # Dense or Conv
        kernel = np.asarray(node["kernel"])
        if kernel.ndim == 4:
            weight = kernel.transpose(3, 2, 0, 1)
        else:
            chw = getattr(module.get_submodule(prefix), "nhwc_from", None)
            weight = (_nhwc_rows_to_nchw(kernel, chw) if chw is not None
                      else kernel.T)
        yield f"{prefix}.weight", weight
        if "bias" in node:
            yield f"{prefix}.bias", np.asarray(node["bias"])
    elif keys == {"embedding"}:                  # Embed
        yield f"{prefix}.weight", np.asarray(node["embedding"])
    elif keys == {"scale", "bias"} and all(
            not isinstance(v, Mapping) for v in node.values()):  # LayerNorm
        yield f"{prefix}.weight", np.asarray(node["scale"])
        yield f"{prefix}.bias", np.asarray(node["bias"])
    else:
        for key, child in node.items():
            yield from _leaves(child, path + (_part(key),), module)


def _state_names(module) -> set:
    """The buffers that are model state (BatchNorm statistics): flax keeps
    them in ``batch_stats``, not in the param tree."""
    return {f"{path}.{b}" if path else b
            for path, sub in module.named_modules()
            if isinstance(sub, BatchNorm) for b in ("mean", "var")}


def _from_leaves(leaves, dest: dict, what: str) -> dict:
    """``{name: tensor}`` from (name, array) pairs: every name of ``dest``
    written exactly once at its own shape, in its dtype and device."""
    out = {}
    for name, arr in leaves:
        if name not in dest:
            raise KeyError(f"flax leaf {name!r} has no counterpart in "
                           f"{what}")
        if name in out:
            raise KeyError(f"flax leaf {name!r} is written twice")
        t = dest[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: flax shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=t.dtype, device=t.device)
    missing = sorted(set(dest) - set(out))
    if missing:
        raise KeyError(f"the flax tree does not provide {missing}")
    return out


def tensors_from_jax(tree, module) -> dict:
    """The flax tree ``tree`` as ``{name: tensor}`` for ``module``'s
    parameters and persistent buffers other than BatchNorm statistics
    (new tensors, each in the destination's dtype and device); ``module``
    is not modified."""
    skip = _state_names(module)
    dest = {k: v for k, v in module.state_dict().items() if k not in skip}
    return _from_leaves(_leaves(tree, (), module), dest,
                        type(module).__name__)


def _stat_leaves(node, path):
    if not isinstance(node, Mapping):
        yield ".".join(path), np.asarray(node)
        return
    for key, child in node.items():
        yield from _stat_leaves(child, path + (_part(key),))


def state_from_jax(batch_stats, module, stacked: bool = False) -> dict:
    """flax's ``batch_stats`` collection (nested dicts of ``mean``/``var``
    arrays) as ``{buffer name: tensor}`` for ``module``'s BatchNorm state,
    every buffer written exactly once at its shape, or this raises. With
    ``stacked`` every leaf carries a leading worker axis (the engine's
    ``nt``), kept in the result."""
    buffers = dict(module.named_buffers())
    dest = {k: buffers[k] for k in _state_names(module)}
    leaves = _stat_leaves(batch_stats, ())
    if not stacked:
        return _from_leaves(leaves, dest, f"{type(module).__name__}'s state")
    leaves = list(leaves)
    w = {arr.shape[0] for _, arr in leaves}
    if len(w) > 1:
        raise ValueError(f"stacked batch_stats disagree on the worker "
                         f"count: {sorted(w)}")
    n = w.pop() if w else 0
    dest = {k: v.expand((n,) + tuple(v.shape)) for k, v in dest.items()}
    return _from_leaves(leaves, dest, f"{type(module).__name__}'s state")


def state_to_jax(state, module) -> dict:
    """The BatchNorm entries of ``{buffer name: tensor}`` state → flax's
    ``batch_stats`` collection, nested dicts of numpy arrays keyed by flax
    names; other buffers (position tables) are not flax state and are
    left out."""
    names = _state_names(module)
    tree: dict = {}
    for name, t in state.items():
        if name not in names:
            continue
        mod_path, _, attr = name.rpartition(".")
        node = tree
        for p in _flax_parts(mod_path):
            node = node.setdefault(p, {})
        node[attr] = np.ascontiguousarray(_to_numpy(t))
    return tree


def params_from_jax(tree, module):
    """Copy the flax param tree ``tree`` into ``module`` in place and
    return it."""
    dest = module.state_dict()
    with torch.no_grad():
        for name, t in tensors_from_jax(tree, module).items():
            dest[name].copy_(t)
    return module


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_to_jax(params, module) -> dict:
    """``{name: tensor}`` params of ``module`` (or ``None`` for the
    module's own) → the flax param tree, nested dicts of numpy arrays."""
    if params is None:
        skip = _state_names(module)
        params = {k: v for k, v in module.state_dict().items()
                  if k not in skip}
    tree: dict = {}
    for name, t in params.items():
        mod_path, _, attr = name.rpartition(".")
        sub = module.get_submodule(mod_path) if mod_path else module
        arr = _to_numpy(t)
        parts = _flax_parts(mod_path)
        if isinstance(sub, (nn.Embedding, Embed)) and attr == "weight":
            leaf = {"embedding": arr}
        elif isinstance(sub, (nn.LayerNorm, BatchNorm)):
            leaf = {"scale" if attr == "weight" else attr: arr}
        elif attr == "kernel_q":
            leaf = {"kernel_q": arr.T}
        elif attr == "weight" and arr.ndim == 4:
            leaf = {"kernel": arr.transpose(2, 3, 1, 0)}
        elif attr == "weight" and arr.ndim == 2:
            chw = getattr(sub, "nhwc_from", None)
            leaf = {"kernel": _nchw_cols_to_nhwc(arr, chw) if chw is not None
                    else arr.T}
        elif attr in ("bias", "scale") and mod_path:
            leaf = {attr: arr}
        else:                                    # bare parameter
            parts, leaf = parts + [attr], arr
        node = tree
        for p in parts[:-1] if not isinstance(leaf, dict) else parts:
            node = node.setdefault(p, {})
        if isinstance(leaf, dict):
            node.update({k: np.ascontiguousarray(v) for k, v in leaf.items()})
        else:
            node[parts[-1]] = np.ascontiguousarray(leaf)
    return tree


def center_from_jax(tree, spec) -> dict:
    """The center of a checkpoint the JAX package wrote (a flax param tree,
    as ``checkpoint.load_checkpoint`` rebuilds it) as ``spec``'s params,
    ``{name: tensor}`` on the CPU in the spec's dtypes. Every leaf must land
    on a tensor of ``spec.module`` at that tensor's shape and every tensor
    must be written, or this raises (:func:`tensors_from_jax`): a misread
    never loads quietly."""
    if spec.module is None:
        raise ValueError(
            f"spec {spec.name!r} has no template module, so a JAX-package "
            f"checkpoint has nothing to map onto (build the spec with "
            f"model.from_module)")
    names = {k for k, _ in spec.module.named_parameters()}
    out = tensors_from_jax(tree, spec.module)
    if set(out) != names:
        raise KeyError(f"the checkpoint's center maps onto {sorted(out)}, "
                       f"the spec's params are {sorted(names)}")
    return out


def _tree_index(node, i):
    if isinstance(node, Mapping):
        return {k: _tree_index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def stages_from_jax(split, module) -> dict:
    """The JAX package's pipeline engine layout, ``{"stages": the block
    tree with every leaf stacked on a leading [S], "rest": the other
    leaves}`` (``parallel.strategies.split_pipeline_params`` there), as
    the port's: ``{name: tensor}`` with the blocks' leaves under
    ``stages.<leaf> [S, …]`` (the port's ``split_pipeline_params``)."""
    from distkeras_tpu_torch.parallel.strategies import split_pipeline_params

    first = split["stages"]
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    depth = int(np.shape(first)[0])
    tree = dict(split["rest"])
    for i in range(depth):
        tree[f"blocks_{i}"] = _tree_index(split["stages"], i)
    return split_pipeline_params(tensors_from_jax(tree, module), depth)


def nt_from_jax(nt, spec) -> dict:
    """The stacked non-trainable state of a checkpoint the JAX package
    wrote (``{"batch_stats": tree}`` with a leading worker axis, or
    ``{}`` for a stateless model) as ``spec``'s BatchNorm state,
    ``{buffer name: tensor [W, ...]}`` on the CPU: the state counterpart
    of :func:`center_from_jax`, under the same rule that a misread never
    loads quietly."""
    if spec.module is None:
        raise ValueError(
            f"spec {spec.name!r} has no template module, so a JAX-package "
            f"checkpoint has nothing to map onto (build the spec with "
            f"model.from_module)")
    extra = sorted(set(nt) - {"batch_stats"})
    if extra:
        raise KeyError(f"the checkpoint's nt holds collections {extra} the "
                       f"port has no state for")
    return state_from_jax(nt.get("batch_stats", {}), spec.module,
                          stacked=True)
