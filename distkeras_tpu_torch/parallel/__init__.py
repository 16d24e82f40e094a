"""The training engine of the port: merge rules and the local-SGD window
engine (collective backend, every worker stacked on one card) with its
``worker_mean`` over the stacked workers, the single-device mixture of
experts (``expert``), and the commit codecs of the parameter-server
backend (``compression``)."""

from distkeras_tpu_torch.parallel.expert import moe_mlp_reference
from distkeras_tpu_torch.parallel.local_sgd import (
    LocalSGDEngine,
    TrainState,
    worker_mean,
)
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
    get_merge_rule,
)

__all__ = ["LocalSGDEngine", "TrainState", "worker_mean",
           "moe_mlp_reference", "MergeRule", "ADAGMerge",
           "DownpourMerge", "ElasticAverageMerge", "DynSGDMerge",
           "get_merge_rule"]
