"""Weight bridge: the JAX package's LM param tree → the port's modules.

``params_from_jax(tree, module)`` takes a flax param tree as nested dicts of
numpy arrays — ``spec.init_np(0)``, a trained tree, or ``quantize_lm``'s
int8 tree — and copies it into a :class:`~distkeras_tpu_torch.models.lm.
TransformerLM` built with the same configuration. flax names map one to
one: ``blocks_i/{ln_attn,qkv,attn_out,ln_mlp,mlp_up,mlp_down}``,
``embed/embedding``, ``ln_head``, ``lm_head``. A Dense ``kernel [in, out]``
becomes ``weight [out, in]``; an int8 ``kernel_q [in, out]`` becomes
``kernel_q [out, in]``, the layout the q_matmul kernel streams (see
``csrc/quant.cu``); ``scale`` and ``bias`` copy as they are; a LayerNorm's
``scale`` becomes ``weight``. Every destination tensor must be written
exactly once, at its own shape, or the bridge raises. Values are cast to
the destination's dtype (f32 → bf16 rounds to nearest even, as
``astype``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np


def _leaves(node, path):
    """(torch name, array) pairs for one flax subtree."""
    if not isinstance(node, Mapping):
        raise TypeError(f"unexpected leaf at {'/'.join(path)}")
    keys = set(node)
    prefix = ".".join(path)
    if "kernel_q" in keys:                       # QDense
        yield f"{prefix}.kernel_q", np.asarray(node["kernel_q"]).T
        yield f"{prefix}.scale", np.asarray(node["scale"])
        if "bias" in node:
            yield f"{prefix}.bias", np.asarray(node["bias"])
    elif "kernel" in keys:                       # Dense
        yield f"{prefix}.weight", np.asarray(node["kernel"]).T
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
            part = key
            if key.startswith("blocks_") and key[7:].isdigit():
                part = f"blocks.{key[7:]}"
            yield from _leaves(child, path + (part,))


def params_from_jax(tree, module):
    """Copy the flax param tree ``tree`` into ``module`` in place and
    return it."""
    dest = module.state_dict()
    seen = set()
    for name, arr in _leaves(tree, ()):
        if name not in dest:
            raise KeyError(f"flax leaf {name!r} has no counterpart in "
                           f"{type(module).__name__}")
        t = dest[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: flax shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        t.copy_(t.new_tensor(np.ascontiguousarray(arr)))
        seen.add(name)
    missing = sorted(set(dest) - seen)
    if missing:
        raise KeyError(f"the flax tree does not provide {missing}")
    return module
