"""Fully-sharded data parallelism (ZeRO-3). Port of
``distkeras_tpu/parallel/fsdp.py``.

:func:`fsdp_specs` is the JAX package's rule: every leaf is sharded along
ONE dim over the data axis, the largest dim whose extent divides the shard
count among those not already taken (by Megatron's ``tp`` rules when
composed), ties going to the earlier dim in the JAX package's layout
(flax ``kernel [in, out]``: the port's ``weight [out, in]`` is walked
backwards). Leaves under ``min_size`` elements stay replicated.

:class:`FSDPEngine` is :class:`~distkeras_tpu_torch.parallel.tensor.
SPMDEngine` with those specs: each rank stores its shard of every
parameter and of the optimizer's moments; the forward all-gathers a leaf
before use (``mesh.gather_shards``) and its backward reduce-scatters the
gradient, which the engine then averages over ``dp``. It does not use
FSDP2's ``fully_shard``, which always shards dim 0: the layouts, specs and
``.dks`` shards would differ from the JAX package's.
"""

from __future__ import annotations

from distkeras_tpu_torch.parallel.tensor import (
    SPMDEngine,
    full_spec,
    megatron_specs,
)

#: leaves smaller than this stay replicated (biases, norms)
DEFAULT_MIN_SIZE = 2048


def _jax_dim_order(name: str, ndim: int) -> tuple:
    """The port's dims of a leaf in the order of the JAX package's dims:
    a Dense weight ``[out, in]`` is flax's ``[in, out]``, a conv ``OIHW``
    flax's ``HWIO``; a pipeline stage leaf (``stages.…``) keeps its
    leading ``[S]``."""
    stacked = name.startswith("stages.")
    base = ndim - 1 if stacked else ndim
    parts = name.split(".")
    if parts[-1] == "weight" and "embed" not in parts and base == 2:
        order = (1, 0)
    elif parts[-1] == "weight" and base == 4:
        order = (2, 3, 1, 0)
    else:
        order = tuple(range(base))
    return (0,) + tuple(d + 1 for d in order) if stacked else order


def fsdp_specs(params: dict, n_shards: int, axis: str = "dp",
               base_specs=None, min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """The ZeRO-3 spec of every leaf of a ``{name: tensor}`` tree."""
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        base = () if base_specs is None else tuple(base_specs[name])
        taken = full_spec(base, len(shape))
        size = 1
        for n in shape:
            size *= int(n)
        if size < min_size:
            out[name] = base
            continue
        best = None
        for d in _jax_dim_order(name, len(shape)):
            if taken[d] is not None or shape[d] % n_shards:
                continue
            if best is None or shape[d] > shape[best]:
                best = d
        if best is None:
            out[name] = base
            continue
        new = list(taken)
        new[best] = axis
        while new and new[-1] is None:
            new.pop()
        out[name] = tuple(new)
    return out


class FSDPEngine(SPMDEngine):
    """:class:`SPMDEngine` whose default layout is ZeRO-3 over ``dp``;
    ``tensor_parallel=True`` applies the Megatron rules over ``tp`` first
    and shards the remaining dims over ``dp``."""

    def __init__(self, spec, loss_step, optimizer, mesh, dp_axis="dp",
                 tp_axis="tp", tensor_parallel=False,
                 min_size: int = DEFAULT_MIN_SIZE, param_specs=None,
                 grad_accum: int = 1, clipnorm=None):
        super().__init__(spec, loss_step, optimizer, mesh,
                         param_specs=param_specs, dp_axis=dp_axis,
                         tp_axis=tp_axis, grad_accum=grad_accum,
                         clipnorm=clipnorm)
        self.tensor_parallel = bool(tensor_parallel)
        self.min_size = int(min_size)

    def _default_specs(self, params) -> dict:
        base = (megatron_specs(params, self.tp_axis)
                if self.tensor_parallel else None)
        return fsdp_specs(params, self.mesh.size(self.dp_axis),
                          axis=self.dp_axis, base_specs=base,
                          min_size=self.min_size)


__all__ = ["DEFAULT_MIN_SIZE", "FSDPEngine", "fsdp_specs"]
