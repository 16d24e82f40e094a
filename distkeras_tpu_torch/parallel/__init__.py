"""The training engines of the port: merge rules and the local-SGD window
engine (collective backend, every worker stacked on one card) with its
``worker_mean`` over the stacked workers; the parallelism portfolio over a
``torch.distributed`` mesh (``mesh``, Megatron ``tensor``, ``fsdp``,
``pipeline``, ``sequence``, ``expert``; the trainer seams in
``strategies``); and the commit codecs of the parameter-server backend
(``compression``)."""

from distkeras_tpu_torch.parallel.mesh import get_mesh, mesh_info
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
    get_merge_rule,
)
from distkeras_tpu_torch.parallel.local_sgd import (
    LocalSGDEngine,
    TrainState,
    worker_mean,
)
from distkeras_tpu_torch.parallel.expert import (
    init_moe_params,
    moe_mlp,
    moe_mlp_reference,
)
from distkeras_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    sequential_apply,
    stack_stage_params,
)
from distkeras_tpu_torch.parallel.sequence import (
    attention_reference,
    ring_attention,
    ring_attention_shard,
)
from distkeras_tpu_torch.parallel.tensor import (
    SPMDEngine,
    get_mesh_nd,
    megatron_specs,
    shard_pytree,
)
from distkeras_tpu_torch.parallel.fsdp import FSDPEngine, fsdp_specs

__all__ = [
    "attention_reference",
    "ring_attention",
    "ring_attention_shard",
    "pipeline_apply",
    "sequential_apply",
    "stack_stage_params",
    "init_moe_params",
    "moe_mlp",
    "moe_mlp_reference",
    "SPMDEngine",
    "FSDPEngine",
    "fsdp_specs",
    "get_mesh_nd",
    "megatron_specs",
    "shard_pytree",
    "get_mesh",
    "mesh_info",
    "MergeRule",
    "ADAGMerge",
    "DownpourMerge",
    "ElasticAverageMerge",
    "DynSGDMerge",
    "get_merge_rule",
    "LocalSGDEngine",
    "TrainState",
    "worker_mean",
]
