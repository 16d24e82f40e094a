"""Deterministic fault injection for the PS wire and the hogwild workers.

Port of ``distkeras_tpu/resilience/faults.py``. :class:`FaultPlan` is a
seeded plan of wire faults (drops, delays, op-count partitions) and
worker faults (kill at a window, persistent stragglers), installed behind
the port's ``networking._fault_hook`` seam and consulted by the
``AsyncWorker`` window loop; ``kill_ps_after_commits`` is consulted by the
trainer-side failover wiring. The chip smoke and the tests drive the same
plan.

Determinism: every wire-fault decision comes from one ``Philox``-seeded
generator consumed under a lock in call order, and worker kills key on
``(worker_id, window_index)``: no wall clock anywhere, so the same seed
and the same per-thread call sequences draw the same faults as the JAX
package's plan.

A drop raises :class:`FaultInjectedError`, a ``ProtocolError`` (so a
``ConnectionError``): server handlers and the client retry layer treat it
as a torn connection. ``max_faults`` bounds the injected wire faults, so
a chaotic run always drains to completion.

The plan also carries the JAX package's elastic-membership events
(``join_worker_at_window``, ``preempt_worker_at_window``; ``ROADMAP.md``
A7.8) and membership-directory faults (A7.9) with the same decisions;
the port's trainers refuse a plan that carries them, since nothing here
consults them yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import ProtocolError


class FaultInjectedError(ProtocolError):
    """A fault-plan drop: looks like a torn connection to every consumer
    (retryable by policy, connection-dropping for server handlers)."""

    def __init__(self, message: str):
        super().__init__(message, retryable=True)


class WorkerKilled(RuntimeError):
    """A fault-plan worker kill (crash-at-window-N): the supervisor treats
    it like any other worker death — restart budget permitting."""


class FaultPlan:
    """A seeded, deterministic plan of faults to inject into one run.

    Wire faults (consulted by ``networking.send_data``/``recv_data`` while
    installed):

    - ``drop_send`` / ``drop_recv``: per-op probability of raising
      :class:`FaultInjectedError` instead of performing the op. A recv
      drop is the nasty one — the peer already acted on the request, so a
      naive client retry would double-apply it (the commit-seqno dedup in
      the PS exists exactly for this).
    - ``delay`` / ``delay_s``: per-op probability of sleeping ``delay_s``
      before the op (slow-link / GC-pause stand-in).
    - ``partition_after`` / ``partition_ops``: after ``partition_after``
      wire ops, the next ``partition_ops`` ops all drop — a deterministic
      network partition window keyed on op count, not wall time.

    Worker faults (consulted by ``AsyncWorker`` at each window):

    - ``kill_at``: ``{worker_id: window_index}`` — the worker raises
      :class:`WorkerKilled` when it reaches that window (once; a
      restarted worker passing the same index survives).
    - ``straggle``: ``{worker_id: seconds}`` — the worker sleeps that
      long at EVERY window boundary: a deterministic persistent
      straggler (slow host, thermal throttle, noisy neighbor stand-in).
      Same seam as ``kill_at``, no randomness at all.

    Elastic-membership faults (``ROADMAP.md`` A7.8; keyed on the same
    deterministic (worker_id, window_index) seam as ``kill_at``):

    - ``join_worker_at_window``: ``{observer_worker_id: window_index}`` —
      at the observer's first window boundary AT OR AFTER that index,
      ONE new worker live-joins the pool (fresh id, live-join
      handshake). Fires once per entry.
    - ``preempt_worker_at_window``: ``{victim_worker_id: window_index}``
      — at the victim's first window boundary at or after that index it
      receives a preemption notice and starts a bounded-deadline drain.
      Fires once per entry.

    Parameter-server faults (consulted by the trainer-side failover
    wiring, ``resilience/recovery.py``):

    - ``kill_ps_after_commits``: crash-stop the PRIMARY parameter server
      (``_crash()``: connections torn, no final fsync) once its applied
      commit count crosses this threshold — deterministic in commit
      count, not wall time. Fires once per run; the supervisor then
      proves the failover (hot-standby promotion or WAL
      restart-in-place). Requires a recovery path on the trainer
      (``ps_standby=True`` or ``ps_wal_dir``).
    - ``kill_shard_id``: which shard of a sharded center the kill
      targets (sharding is ``ROADMAP.md`` A7.7).

    Membership-directory faults (``ROADMAP.md`` A7.9; decided per op on
    the directory primary):

    - ``kill_directory_after_ops``: crash-stop the directory primary
      (``_crash()``: connections torn, WAL abandoned) once it has
      handled this many ops — deterministic in op count. Fires once;
      the directory failover supervisor then proves the promotion, and
      every consumer's next lookup re-probes the seeds onto the
      promoted replica.
    - ``directory_partition_after`` / ``directory_partition_ops``:
      after N directory ops, the next K all drop (torn connection to
      the caller) — a deterministic directory partition window. The
      training hot path must ride it out untouched: the directory is
      consulted only at build/reconnect time.

    ``max_faults`` caps drops+partition hits (delays excluded) so runs
    terminate; ``stats()`` reports what was actually injected.
    """

    def __init__(self, seed: int = 0, drop_send: float = 0.0,
                 drop_recv: float = 0.0, delay: float = 0.0,
                 delay_s: float = 0.0, partition_after: int | None = None,
                 partition_ops: int = 0,
                 kill_at: dict[int, int] | None = None,
                 straggle: dict[int, float] | None = None,
                 max_faults: int | None = None,
                 kill_ps_after_commits: int | None = None,
                 kill_shard_id: int | None = None,
                 join_worker_at_window: dict[int, int] | None = None,
                 preempt_worker_at_window: dict[int, int] | None = None,
                 kill_directory_after_ops: int | None = None,
                 directory_partition_after: int | None = None,
                 directory_partition_ops: int = 0):
        for name, p in (("drop_send", drop_send), ("drop_recv", drop_recv),
                        ("delay", delay)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        self.seed = int(seed)
        self.drop_send = float(drop_send)
        self.drop_recv = float(drop_recv)
        self.delay = float(delay)
        self.delay_s = float(delay_s)
        self.partition_after = partition_after
        self.partition_ops = int(partition_ops)
        self.kill_at = dict(kill_at or {})
        self.straggle = {
            int(w): float(s) for w, s in (straggle or {}).items()
        }
        for w, s in self.straggle.items():
            if s < 0:
                raise ValueError(
                    f"straggle[{w}] must be >= 0 seconds, got {s}"
                )
        self.max_faults = max_faults
        self.kill_ps_after_commits = (
            None if kill_ps_after_commits is None
            else int(kill_ps_after_commits)
        )
        if kill_shard_id is not None and kill_shard_id < 0:
            raise ValueError(
                f"kill_shard_id must be >= 0, got {kill_shard_id}"
            )
        self.kill_shard_id = (
            None if kill_shard_id is None else int(kill_shard_id)
        )
        self.join_worker_at_window = dict(join_worker_at_window or {})
        self.preempt_worker_at_window = dict(preempt_worker_at_window or {})
        self.kill_directory_after_ops = (
            None if kill_directory_after_ops is None
            else int(kill_directory_after_ops)
        )
        self.directory_partition_after = (
            None if directory_partition_after is None
            else int(directory_partition_after)
        )
        self.directory_partition_ops = int(directory_partition_ops)
        self._rng = np.random.Generator(np.random.Philox(self.seed))
        self._lock = threading.Lock()
        self._ops = 0
        self._killed: set[int] = set()
        self._joined: set[int] = set()
        self._preempted: set[int] = set()
        self._ps_killed = False
        self._directory_killed = False
        self._n_drops = 0
        self._n_delays = 0
        self._n_partition_drops = 0
        self._n_kills = 0
        self._n_straggles = 0
        self._n_joins = 0
        self._n_preempts = 0
        self._n_ps_kills = 0
        self._n_directory_ops = 0
        self._n_directory_kills = 0
        self._n_directory_drops = 0

    # -- wire hook (installed into networking._fault_hook) -------------------

    def _wire(self, op: str, sock: Any) -> None:
        """The networking seam: decide this op's fate under the lock (the
        generator is shared state), sleep OUTSIDE it (a delay must stall
        one connection, not serialize every other thread's faults)."""
        sleep_s = 0.0
        with self._lock:
            self._ops += 1
            budget = (self.max_faults is None
                      or (self._n_drops + self._n_partition_drops)
                      < self.max_faults)
            if (budget and self.partition_after is not None
                    and self.partition_after < self._ops
                    <= self.partition_after + self.partition_ops):
                self._n_partition_drops += 1
                raise FaultInjectedError(
                    f"injected partition (op {self._ops})"
                )
            p_drop = self.drop_send if op == "send" else self.drop_recv
            if budget and p_drop and self._rng.random() < p_drop:
                self._n_drops += 1
                raise FaultInjectedError(
                    f"injected {op} drop (op {self._ops})"
                )
            if self.delay and self._rng.random() < self.delay:
                self._n_delays += 1
                sleep_s = self.delay_s
        if sleep_s > 0.0:
            time.sleep(sleep_s)

    # -- worker hook ---------------------------------------------------------

    def maybe_kill(self, worker_id: int, window_index: int) -> None:
        """Raise :class:`WorkerKilled` when ``worker_id`` reaches its
        configured window — once; restarts replay the window unharmed."""
        step = self.kill_at.get(worker_id)
        if step is None or window_index != step:
            return
        with self._lock:
            if worker_id in self._killed:
                return
            self._killed.add(worker_id)
            self._n_kills += 1
        raise WorkerKilled(
            f"injected kill: worker {worker_id} at window {window_index}"
        )

    def maybe_straggle(self, worker_id: int) -> None:
        """Sleep the configured straggler delay at a window boundary
        (no-op for workers without one). Deterministic: every window,
        same duration — the persistent-straggler shape, not jitter."""
        s = self.straggle.get(worker_id)
        if not s:
            return
        with self._lock:
            self._n_straggles += 1
        time.sleep(s)

    # -- elastic-membership hooks (ROADMAP.md A7.8) -------------------------

    def take_join(self, worker_id: int, window_index: int) -> bool:
        """True exactly once, at ``worker_id``'s first window boundary AT
        OR AFTER its configured trigger (``>=``, not ``==``: a worker
        slowed by concurrent wire chaos must still fire the event at its
        next boundary instead of skipping past it): the coordinator
        should live-join one new worker now. Deterministic in the
        worker's own completed-window count — a restarted worker
        replaying windows does not re-trigger."""
        step = self.join_worker_at_window.get(worker_id)
        if step is None or window_index < step:
            return False
        with self._lock:
            if worker_id in self._joined:
                return False
            self._joined.add(worker_id)
            self._n_joins += 1
        return True

    def take_preempt(self, worker_id: int, window_index: int) -> bool:
        """True exactly once, at ``worker_id``'s first window boundary at
        or after its configured preemption point (same ``>=`` semantics
        as :meth:`take_join`): the worker should receive a preemption
        notice and start its bounded-deadline drain."""
        step = self.preempt_worker_at_window.get(worker_id)
        if step is None or window_index < step:
            return False
        with self._lock:
            if worker_id in self._preempted:
                return False
            self._preempted.add(worker_id)
            self._n_preempts += 1
        return True

    # -- parameter-server hook (PSFailoverSupervisor) ------------------------

    def should_kill_ps(self, num_updates: int) -> bool:
        """True exactly until the kill is taken: the primary PS should be
        crash-stopped now (its commit count crossed the threshold)."""
        if self.kill_ps_after_commits is None:
            return False
        with self._lock:
            return (not self._ps_killed
                    and num_updates >= self.kill_ps_after_commits)

    def note_ps_kill(self) -> None:
        with self._lock:
            self._ps_killed = True
            self._n_ps_kills += 1

    # -- membership-directory hook (ROADMAP.md A7.9) -------------------------

    def take_directory_op(self) -> str:
        """Consulted once per handled op on the directory PRIMARY:
        ``"kill"`` exactly once when the op count crosses the kill
        threshold, ``"drop"`` inside the partition window, else
        ``"ok"``. Deterministic in op count — no wall clock, no rng."""
        with self._lock:
            self._n_directory_ops += 1
            ops = self._n_directory_ops
            if (self.kill_directory_after_ops is not None
                    and not self._directory_killed
                    and ops >= self.kill_directory_after_ops):
                self._directory_killed = True
                self._n_directory_kills += 1
                return "kill"
            if (self.directory_partition_after is not None
                    and self.directory_partition_after < ops
                    <= (self.directory_partition_after
                        + self.directory_partition_ops)):
                self._n_directory_drops += 1
                return "drop"
        return "ok"

    @property
    def has_directory_events(self) -> bool:
        """Whether the plan carries directory faults (they need a hosted
        directory — without ``directory=True`` nothing ever consults
        them, so the chaos would silently test nothing)."""
        return (self.kill_directory_after_ops is not None
                or self.directory_partition_after is not None)

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> None:
        """Install the wire hook; exactly one plan may be active."""
        if networking._fault_hook is not None:
            raise RuntimeError("a FaultPlan is already installed")
        networking._fault_hook = self._wire

    def uninstall(self) -> None:
        # == not `is`: each `self._wire` access builds a fresh bound method
        if networking._fault_hook == self._wire:
            networking._fault_hook = None

    def __enter__(self) -> "FaultPlan":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def stats(self) -> dict:
        """What the plan actually injected (for assertions and chaos-bench
        records)."""
        with self._lock:
            return {
                "wire_ops": self._ops,
                "drops": self._n_drops,
                "partition_drops": self._n_partition_drops,
                "delays": self._n_delays,
                "kills": self._n_kills,
                "straggles": self._n_straggles,
                "joins": self._n_joins,
                "preempts": self._n_preempts,
                "ps_kills": self._n_ps_kills,
                "directory_ops": self._n_directory_ops,
                "directory_kills": self._n_directory_kills,
                "directory_drops": self._n_directory_drops,
            }

    @property
    def has_elastic_events(self) -> bool:
        """Whether the plan carries join/preempt membership events (they
        need an elastic trainer — the fixed-pool loop never consults
        them, so running them there would silently test nothing)."""
        return bool(self.join_worker_at_window
                    or self.preempt_worker_at_window)
