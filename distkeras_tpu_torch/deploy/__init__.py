"""Live deployment: stream weights from the training PS into the serving
tier, hot-swap them between decode steps, and orchestrate a canary
rollout with rollback across the serving fleet. Port of
``distkeras_tpu/deploy``.

- :mod:`~distkeras_tpu_torch.deploy.stream`: serving-side read replicas
  of the training center. A :class:`ReadReplica` speaks the
  chain-replication record protocol of the hot standby (the primary's
  ``attach_standby`` connects to it), applies records through the shared
  ``wal.replay_record`` and forwards the raw frames down a chain, so N
  serving hosts share one stream off the trainer. A
  :class:`WeightStreamer` owns one replica a shard, cuts versioned
  snapshots at fold-count and epoch boundaries (never a commit at a
  time), assembles a sharded center's consistent cut and reports the
  published version back into ``ps.stats()["deploy_lag_folds"]``.
- The serving engine's swap gate, ``GenerationEngine.swap_params``,
  stages ``(weights, version)`` and applies them between decode steps, so
  no step mixes two weight sets; ``GenerationServer``'s
  ``deploy_activate`` action stages a stored snapshot.
- :mod:`~distkeras_tpu_torch.deploy.rollout`: a pure hysteresis state
  machine (:class:`RolloutPolicy`) and the :class:`RolloutController`
  that pins a canary fraction of directory-registered replicas to a
  candidate version, promotes it on a green health signal and rolls it
  back when the serving SLO fires.
"""

from distkeras_tpu_torch.deploy.rollout import (  # noqa: F401
    RolloutController,
    RolloutPolicy,
    watchtower_health,
)
from distkeras_tpu_torch.deploy.stream import (  # noqa: F401
    ModelSnapshot,
    ReadReplica,
    SnapshotStore,
    WeightStreamer,
)

__all__ = [
    "ModelSnapshot",
    "ReadReplica",
    "SnapshotStore",
    "WeightStreamer",
    "RolloutPolicy",
    "RolloutController",
    "watchtower_health",
]
