"""The training engine of the port: merge rules and the local-SGD window
engine (collective backend, every worker stacked on one card)."""

from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine, TrainState
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
)

__all__ = ["LocalSGDEngine", "TrainState", "MergeRule", "ADAGMerge",
           "DownpourMerge", "ElasticAverageMerge", "DynSGDMerge"]
