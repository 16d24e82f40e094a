"""Worker liveness: leases, heartbeats and stale-worker eviction.

Port of ``distkeras_tpu/resilience/heartbeat.py``. Each worker holds a
**lease** on the server, renewed by heartbeats its training loop sends at
window boundaries (piggybacked: no extra thread, no extra connection). A
worker that stops renewing past ``lease_timeout`` is **evicted**: its lease
is dropped, the eviction is counted in ``ps.stats()``, and the server's
eviction callback forgets the worker's pull version, so a zombie commit is
priced by DynSGD at the whole center history (τ = num_updates) and folds
at almost nothing.

A leased worker's own requests (pulls, commits, exchanges) extend its
lease too (:meth:`WorkerRegistry.touch`), which the JAX package's registry
does not do: there a worker whose window outlasts its lease can be
evicted between a commit that folded and the replay of its lost ACK, and
the eviction, retiring the worker's dedup entry, lets the replay fold a
second time (``ROADMAP.md`` queue C). A request renews only an existing
lease: a worker that never heartbeats stays unleased, and an evicted one
is re-admitted by its next heartbeat, as before.

The registry is transport-neutral (the in-process, socket and shm servers
share it through the base ``ParameterServer``; the C++ server keeps the
same lease rules natively) and takes an injectable clock for tests. Expiry
scans are O(workers) and rate-limited to a quarter lease, so the commit
path stays O(fold).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class Lease:
    """One worker's liveness record."""

    __slots__ = ("worker_id", "deadline", "renewals")

    def __init__(self, worker_id: int, deadline: float):
        self.worker_id = worker_id
        self.deadline = deadline
        self.renewals = 0


class WorkerRegistry:
    """Lease table with heartbeat renewal and rate-limited expiry.

    ``renew`` auto-registers (a heartbeat from an unknown or evicted
    worker re-admits it — that's what a recovered worker's first
    heartbeat is). ``on_evict`` runs OUTSIDE the registry lock with the
    evicted ids, so callbacks may take other locks (the PS's center lock)
    without ordering hazards.
    """

    def __init__(self, lease_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_evict: Callable[[list[int]], None] | None = None):
        if lease_timeout <= 0:
            raise ValueError(
                f"lease_timeout must be positive, got {lease_timeout}"
            )
        self.lease_timeout = float(lease_timeout)
        self._clock = clock
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._leases: dict[int, Lease] = {}
        self._evicted_total = 0
        self._heartbeats = 0
        # Latest cumulative client-reported retry count PER WORKER ID,
        # kept across lease lifecycles: clients report running totals, so
        # folding a count into a sum at eviction and accepting the same
        # total again after re-admission would double-count. max() per id,
        # summed at read time, counts each retry exactly once.
        self._retries_by_wid: dict[int, int] = {}
        # expiry scans rate-limit to a quarter lease: liveness detection
        # stays prompt while per-commit overhead stays a clock read
        self._expiry_every = max(self.lease_timeout / 4.0, 1e-3)
        self._next_expiry = self._clock()

    def renew(self, worker_id: int, retries: int = 0) -> bool:
        """Heartbeat: extend (or create) the worker's lease; ``retries``
        is the client's cumulative retry count (monotone — the registry
        stores the latest value per worker and sums across workers).
        Returns True if the lease already existed (a renewal), False if
        this heartbeat (re-)registered the worker."""
        now = self._clock()
        with self._lock:
            self._heartbeats += 1
            lease = self._leases.get(worker_id)
            fresh = lease is None
            if fresh:
                lease = self._leases[worker_id] = Lease(worker_id, 0.0)
            lease.deadline = now + self.lease_timeout
            lease.renewals += 1
            if retries:
                self._retries_by_wid[worker_id] = max(
                    self._retries_by_wid.get(worker_id, 0), int(retries)
                )
        self.expire()
        return not fresh

    def touch(self, worker_id: int) -> None:
        """A request from ``worker_id`` shows it alive: extend its lease if
        it holds one (no heartbeat counted, nobody registered). Called by
        the PS before it records a pull or folds a commit, so a lease
        cannot lapse between a fold and the replay of its lost ACK unless
        the replay itself comes a whole lease later."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(worker_id)
            if lease is not None:
                lease.deadline = now + self.lease_timeout

    def register(self, worker_id: int) -> None:
        """Insert (or refresh) a lease WITHOUT counting a heartbeat — the
        elastic live-join path: the joiner holds a lease from the moment
        it is admitted, but ``heartbeats`` stays a pure count of
        heartbeat ops."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(worker_id)
            if lease is None:
                lease = self._leases[worker_id] = Lease(worker_id, 0.0)
            lease.deadline = now + self.lease_timeout

    def deregister(self, worker_id: int) -> None:
        """Clean exit: drop the lease without counting an eviction (the
        worker's reported retries stay in the run total)."""
        with self._lock:
            self._leases.pop(worker_id, None)

    def expire(self, force: bool = False) -> list[int]:
        """Evict workers whose leases lapsed; returns the newly evicted
        ids. Rate-limited internally — call freely from hot paths;
        ``force=True`` (observability reads) skips the rate limit so a
        stats consumer never sees an already-lapsed lease as live."""
        now = self._clock()
        with self._lock:
            if not force and now < self._next_expiry:
                return []
            self._next_expiry = now + self._expiry_every
            dead = [wid for wid, l in self._leases.items()
                    if l.deadline < now]
            for wid in dead:
                self._leases.pop(wid)
            self._evicted_total += len(dead)
        if dead and self._on_evict is not None:
            self._on_evict(dead)
        return dead

    def active(self) -> list[int]:
        """Currently-leased worker ids (after a forced expiry pass)."""
        self.expire(force=True)
        with self._lock:
            return sorted(self._leases)

    def stats(self) -> dict:
        """Counters folded into ``ps.stats()``: ``active_workers``,
        ``evicted_workers`` (total evictions, re-admissions included),
        ``heartbeats``, and ``worker_retries`` (sum over worker ids of the
        latest cumulative retry count each reported — eviction and
        re-admission cycles never double-count). Runs a FORCED expiry
        pass first: a lapsed lease is never reported as live."""
        self.expire(force=True)
        with self._lock:
            return {
                "active_workers": len(self._leases),
                "evicted_workers": self._evicted_total,
                "heartbeats": self._heartbeats,
                "worker_retries": sum(self._retries_by_wid.values()),
            }
