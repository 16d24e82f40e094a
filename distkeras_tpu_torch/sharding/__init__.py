"""The sharded parameter-server center.

Port of ``distkeras_tpu/sharding/``: the parameter tree split across N PS
shards by byte-weighted consistent hashing over leaf paths (``ring.py``),
each worker's traffic fanned out to every shard in parallel
(``client.py``), and the shard servers run with a WAL, chain replication
and failover a shard (``group.py``). An N-shard run is bit-identical to
the single-PS run: folds are leafwise and every shard sees the global fold
order and the same per-worker staleness.
"""

from distkeras_tpu_torch.sharding.client import ShardedPSClient
from distkeras_tpu_torch.sharding.group import (
    ShardedPSGroup,
    aggregate_ps_stats,
    chain_wal_dir,
    shard_wal_dir,
)
from distkeras_tpu_torch.sharding.ring import HashRing, ShardPlan, stable_hash

__all__ = [
    "HashRing",
    "ShardPlan",
    "ShardedPSClient",
    "ShardedPSGroup",
    "aggregate_ps_stats",
    "chain_wal_dir",
    "shard_wal_dir",
    "stable_hash",
]
