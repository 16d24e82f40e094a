"""The parameter server's resilience layer.

Port of ``distkeras_tpu/resilience/``:

- :mod:`~distkeras_tpu_torch.resilience.faults`: seeded deterministic
  fault injection (:class:`FaultPlan`) for the wire and the worker
  threads.
- :mod:`~distkeras_tpu_torch.resilience.heartbeat`: worker leases and
  heartbeats (:class:`WorkerRegistry`); stale-worker eviction surfaced in
  ``ps.stats()`` and fed into DynSGD's staleness.
- :mod:`~distkeras_tpu_torch.resilience.retry`: :class:`RetryPolicy`
  (exponential backoff, deterministic jitter, deadline) and
  :class:`ResilientPSClient`, a reconnecting client whose commits carry
  per-worker seqnos the server deduplicates (exactly-once folds).
- :mod:`~distkeras_tpu_torch.resilience.recovery`:
  :class:`WorkerSupervisor` (restart dead workers with a budget, from a
  fresh center pull) and :class:`PSFailoverSupervisor` (the trainer-side
  lease on the primary PS: promote the hot standby or restart in place
  from the WAL, repoint every worker's :class:`PSEndpoint`, fence).
- :mod:`~distkeras_tpu_torch.resilience.wal`: :class:`CommitLog` (the
  write-ahead log with group commit, fsync'd snapshots), crash recovery
  (:func:`recover_ps_state`), and the record stream the hot standby
  applies; ``python -m distkeras_tpu_torch.resilience.wal verify <dir>``.

Elastic membership (``elastic.py``) is ``ROADMAP.md`` A7.8.

Trainer knobs: ``retry_policy``, ``heartbeat_interval``,
``lease_timeout``, ``worker_restart_budget``, ``worker_restart_delay``,
``tolerate_worker_failures``, ``fault_plan``, ``ps_wal_dir``,
``ps_snapshot_every``, ``ps_wal_group_window``, ``ps_wal_group_interval``,
``ps_standby`` and ``ps_failover_timeout`` (see ``DistributedTrainer``).
"""

from distkeras_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjectedError,
    FaultPlan,
    WorkerKilled,
)
from distkeras_tpu_torch.resilience.heartbeat import (  # noqa: F401
    Lease,
    WorkerRegistry,
)
from distkeras_tpu_torch.resilience.recovery import (  # noqa: F401
    PSFailoverSupervisor,
    RestartBudgetExceeded,
    WorkerSupervisor,
)
from distkeras_tpu_torch.resilience.retry import (  # noqa: F401
    PSEndpoint,
    ResilientPSClient,
    RetryDeadlineExceeded,
    RetryPolicy,
    is_retryable,
)
from distkeras_tpu_torch.resilience.wal import (  # noqa: F401
    CommitLog,
    recover_ps_state,
)

__all__ = [
    "FaultInjectedError",
    "FaultPlan",
    "WorkerKilled",
    "Lease",
    "WorkerRegistry",
    "PSFailoverSupervisor",
    "RestartBudgetExceeded",
    "WorkerSupervisor",
    "PSEndpoint",
    "ResilientPSClient",
    "RetryDeadlineExceeded",
    "RetryPolicy",
    "is_retryable",
    "CommitLog",
    "recover_ps_state",
]
