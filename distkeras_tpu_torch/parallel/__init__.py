"""The training engine of the port: merge rules and the local-SGD window
engine (collective backend, every worker stacked on one card), and the
commit codecs of the parameter-server backend (``compression``)."""

from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine, TrainState
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
    get_merge_rule,
)

__all__ = ["LocalSGDEngine", "TrainState", "MergeRule", "ADAGMerge",
           "DownpourMerge", "ElasticAverageMerge", "DynSGDMerge",
           "get_merge_rule"]
