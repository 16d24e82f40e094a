"""Cache-affine generation router: spread clients across serving replicas.

Port of ``distkeras_tpu/directory/router.py``. The serving tier scales out
by running N ``GenerationServer`` replicas. :class:`RoutedGenerationClient`
spreads requests across them with prefix-hash affinity: the route key is
a pinned hash of the prompt's first ``prefix_tokens`` tokens, placed on a
consistent-hash ring over the replica set (``sharding/ring.py``'s pinned
``blake2b`` and successor walk), so requests that share a prompt prefix
land on the same replica and its KV cache can reuse them, while distinct
prefixes spread by hash. Replica churn moves about 1/N of the keyspace.

Failover is health-gated: a replica that answers
:class:`~distkeras_tpu_torch.networking.ServerBusyError` or dies
mid-stream is put in a cooldown and the request replays on the next ring
successor (generation is one idempotent request/response; a fixed seed
makes the replayed stream identical), under the retry policy's backoff.
A killed replica therefore drains: its in-flight clients fail over and
complete on the survivors, and new requests stop routing to it.

Replicas come from an explicit list or from a directory lookup (role
``serve``, see :class:`~distkeras_tpu_torch.directory.DirectoryClient`),
refreshed on demand, so registrations and expirations repoint the router
without restarting any client.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Iterable

import numpy as np

from distkeras_tpu_torch.networking import ProtocolError, ServerBusyError
from distkeras_tpu_torch.sharding.ring import stable_hash

__all__ = ["RoutedGenerationClient", "prefix_route_key"]


def prefix_route_key(prompt, prefix_tokens: int = 16) -> int:
    """The pinned route key: a ``blake2b`` hash (``sharding.ring.
    stable_hash`` — never the salted builtin) of the prompt's first
    ``prefix_tokens`` token ids, so every process routes a shared
    system-prompt workload identically."""
    head = np.asarray(prompt).reshape(-1)[: int(prefix_tokens)]
    ids = ",".join(str(int(t)) for t in head)
    return stable_hash(f"prefix:{ids}")


class _ReplicaRing:
    """Consistent-hash ring over replica keys (strings), with the same
    vnode smoothing and distinct-successor walk as ``sharding.ring.
    HashRing`` — generalized from shard ids to replica names so churn
    moves ~1/N of prefixes, not all of them."""

    def __init__(self, keys: Iterable[str], vnodes: int = 64,
                 weights: dict[str, float] | None = None):
        # weighted vnodes: a replica with weight w gets
        # round(vnodes·w) ring points (floor 1 — never unreachable), so
        # the router biases NEW prefixes toward replicas whose prefix
        # caches are already warm. weight 1.0 for everyone reproduces
        # the unweighted ring point-for-point.
        weights = weights or {}
        pts = sorted(
            (stable_hash(f"replica:{k}/vnode:{v}"), k)
            for k in keys
            for v in range(max(1, round(int(vnodes)
                                        * float(weights.get(k, 1.0)))))
        )
        self._hashes = [h for h, _ in pts]
        self._owners = [k for _, k in pts]
        self._distinct = sorted(set(self._owners))

    def successors(self, h: int):
        n = len(self._hashes)
        if n == 0:
            return
        seen: set[str] = set()
        i = bisect_left(self._hashes, h)
        for step in range(n):
            key = self._owners[(i + step) % n]
            if key not in seen:
                seen.add(key)
                yield key
                if len(seen) == len(self._distinct):
                    return


class RoutedGenerationClient:
    """Prefix-affine, health-gated front door over N GenerationServers.

    ``replicas`` is ``{key: (host, port)}`` (or a list of ``(host,
    port)`` pairs, keyed ``host:port``); alternatively pass
    ``directory=`` (a :class:`DirectoryClient` or seed list) and the
    replica set is the directory's ``serve`` role, refreshed whenever a
    route comes up empty or every ``refresh_interval`` seconds.

    Thread-safe: concurrent callers share the per-replica connections
    behind per-replica locks (the generation protocol is strictly
    request/response, so a connection serves one request at a time and
    concurrent same-replica callers queue on its lock).
    """

    def __init__(self, replicas=None, directory=None, *,
                 prefix_tokens: int = 16, vnodes: int = 64,
                 hit_affinity: float = 0.0,
                 policy=None, cooldown: float = 1.0,
                 refresh_interval: float = 2.0,
                 connect_timeout: float = 5.0):
        from distkeras_tpu_torch.directory.client import DirectoryClient
        from distkeras_tpu_torch.resilience.retry import RetryPolicy

        if (replicas is None) == (directory is None):
            raise ValueError(
                "pass exactly one of replicas= (explicit endpoints) or "
                "directory= (discover the 'serve' role)"
            )
        self.directory = None
        if directory is not None:
            self.directory = (directory
                              if isinstance(directory, DirectoryClient)
                              else DirectoryClient(directory))
        self.prefix_tokens = int(prefix_tokens)
        self.vnodes = int(vnodes)
        # hit-rate feedback: each replica's ring weight is
        # 1 + hit_affinity · its advertised prefix_hit_rate, so the
        # FLEET hit rate climbs — warm replicas attract more of the
        # keyspace. 0.0 (default) is the exact legacy unweighted ring;
        # weighting is opt-in because it trades even load for locality.
        if float(hit_affinity) < 0.0:
            raise ValueError(
                f"hit_affinity must be >= 0, got {hit_affinity}"
            )
        self.hit_affinity = float(hit_affinity)
        self.policy = policy if policy is not None else RetryPolicy(
            max_attempts=40, base_delay=0.02, max_delay=0.4, deadline=60.0,
        )
        self.cooldown = float(cooldown)
        self.refresh_interval = float(refresh_interval)
        self.connect_timeout = float(connect_timeout)
        self._lock = threading.Lock()
        self._replicas: dict[str, tuple[str, int]] = {}
        # per-replica registration meta (directory-discovered routers):
        # carries the replica's advertised model_version — the canary
        # promotion decision reads the per-version routed split below
        self._meta: dict[str, dict] = {}
        self._ring: _ReplicaRing | None = None
        self._conns: dict[str, object] = {}
        self._conn_locks: dict[str, threading.Lock] = {}
        self._down_until: dict[str, float] = {}
        self._last_refresh = 0.0
        self._calls = 0
        self.routed: dict[str, int] = {}   # per-replica request counts
        # per-model-version request counts (the version each serving
        # replica ADVERTISED when the request landed on it): the A/B
        # split observability a canary rollout reads
        self.routed_by_version: dict[int, int] = {}
        self.failovers = 0
        if replicas is not None:
            if not isinstance(replicas, dict):
                replicas = {
                    f"{h}:{p}": (h, int(p)) for h, p in replicas
                }
            self._install(replicas)
        else:
            self.refresh(force=True)

    # -- replica set ---------------------------------------------------------

    def _install(self, replicas: dict[str, tuple[str, int]],
                 meta: dict[str, dict] | None = None) -> None:
        with self._lock:
            gone = set(self._replicas) - set(replicas)
            self._replicas = dict(replicas)
            self._meta = {k: dict(meta.get(k) or {}) for k in replicas} \
                if meta is not None else {k: {} for k in replicas}
            weights = None
            if self.hit_affinity:
                weights = {
                    k: 1.0 + self.hit_affinity * float(
                        (self._meta.get(k) or {})
                        .get("prefix_hit_rate", 0.0) or 0.0)
                    for k in replicas
                }
            self._ring = _ReplicaRing(self._replicas, vnodes=self.vnodes,
                                      weights=weights)
            for key in gone:
                conn = self._conns.pop(key, None)
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                self._down_until.pop(key, None)

    def refresh(self, force: bool = False) -> None:
        """Re-read the replica set from the directory (no-op for the
        explicit-list router). A replica whose lease expired drops out
        of the ring; a new registration joins it."""
        if self.directory is None:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh \
                    < self.refresh_interval:
                return
            self._last_refresh = now
        entries = self.directory.lookup("serve")
        self._install(
            {e["key"]: (e["host"], int(e["port"])) for e in entries},
            meta={e["key"]: e.get("meta") for e in entries},
        )

    @property
    def replicas(self) -> dict[str, tuple[str, int]]:
        with self._lock:
            return dict(self._replicas)

    def replica_versions(self) -> dict[str, int]:
        """Each replica's advertised ``model_version`` (0 when its
        registration carries none) — the rollout controller's fleet
        view, and the key set its canary pick orders."""
        with self._lock:
            return {
                k: int((self._meta.get(k) or {}).get("model_version", 0))
                for k in self._replicas
            }

    def replica_hit_rates(self) -> dict[str, float]:
        """Each replica's advertised prefix-cache hit rate (0.0 when its
        registration carries none) — the affinity-weight input, exposed
        for fleet dashboards and the bench."""
        with self._lock:
            return {
                k: float((self._meta.get(k) or {})
                         .get("prefix_hit_rate", 0.0) or 0.0)
                for k in self._replicas
            }

    # -- routing -------------------------------------------------------------

    def _route_order(self, prompt) -> list[str]:
        h = prefix_route_key(prompt, self.prefix_tokens)
        now = time.monotonic()
        with self._lock:
            if self._ring is None:
                return []
            order = list(self._ring.successors(h))
            healthy = [k for k in order
                       if self._down_until.get(k, 0.0) <= now]
        # every replica cooling down: route anyway (the retry policy's
        # backoff is the wait — a router must degrade, not deadlock)
        return healthy or order

    def _conn(self, key: str):
        from distkeras_tpu_torch.serving.server import GenerationClient

        with self._lock:
            conn = self._conns.get(key)
            lock = self._conn_locks.setdefault(key, threading.Lock())
            endpoint = self._replicas.get(key)
        if endpoint is None:
            # a concurrent refresh dropped this replica between routing
            # and connecting: retryable weather — the caller moves to
            # the next ring successor, not a crash
            raise ProtocolError(
                f"serving replica {key!r} left the directory",
                retryable=True,
            )
        host, port = endpoint
        if conn is None:
            conn = GenerationClient(host, port,
                                    connect_timeout=self.connect_timeout)
            with self._lock:
                # a racing builder won: use theirs, close ours
                live = self._conns.get(key)
                if live is None:
                    self._conns[key] = conn
                else:
                    conn.close()
                    conn = live
        return conn, lock

    def _mark_down(self, key: str) -> None:
        with self._lock:
            self._down_until[key] = time.monotonic() + self.cooldown
            conn = self._conns.pop(key, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def generate(self, prompt, **kw) -> np.ndarray:
        """Route one request by prefix affinity; on backpressure or a
        dead replica, fail over to the next ring successor under the
        retry policy's jittered backoff. Raises the last failure when
        the policy's deadline/attempts lapse with no replica serving."""
        from distkeras_tpu_torch.resilience.retry import (
            RetryDeadlineExceeded,
            is_retryable,
        )

        with self._lock:
            self._calls += 1
            salt = self._calls
        delays = self.policy.delays(salt)
        t0 = time.monotonic()
        attempt = 0
        last: BaseException | None = None
        while True:
            order = self._route_order(prompt)
            if not order:
                self.refresh(force=True)
                order = self._route_order(prompt)
            err = None
            for key in order:
                try:
                    conn, lock = self._conn(key)
                    with lock:
                        out = conn.generate(prompt, **kw)
                    with self._lock:
                        self.routed[key] = self.routed.get(key, 0) + 1
                        v = int((self._meta.get(key) or {})
                                .get("model_version", 0))
                        self.routed_by_version[v] = \
                            self.routed_by_version.get(v, 0) + 1
                    return out
                except ServerBusyError as e:
                    # healthy but full: brief cooldown steers the next
                    # requests to a sibling; this one tries the next
                    # successor immediately
                    self._mark_down(key)
                    err = e
                except BaseException as e:  # noqa: BLE001 — triaged below
                    if isinstance(e, ProtocolError) and not e.retryable:
                        raise
                    if not is_retryable(e):
                        raise
                    self._mark_down(key)
                    err = e
                with self._lock:
                    self.failovers += 1
            last = err if err is not None else last
            attempt += 1
            if attempt >= self.policy.max_attempts:
                raise RetryDeadlineExceeded(
                    f"no serving replica answered after {attempt} "
                    f"route attempts: {last}"
                ) from last
            delay = delays.next_delay()
            if time.monotonic() - t0 + delay > self.policy.deadline:
                raise RetryDeadlineExceeded(
                    f"routing deadline of {self.policy.deadline}s "
                    f"exceeded: {last}"
                ) from last
            time.sleep(delay)
            self.refresh(force=True)

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": {k: list(v)
                             for k, v in self._replicas.items()},
                "routed": dict(self.routed),
                "routed_by_version": dict(self.routed_by_version),
                "replica_versions": {
                    k: int((self._meta.get(k) or {})
                           .get("model_version", 0))
                    for k in self._replicas
                },
                "replica_hit_rates": {
                    k: float((self._meta.get(k) or {})
                             .get("prefix_hit_rate", 0.0) or 0.0)
                    for k in self._replicas
                },
                "failovers": self.failovers,
                "cooling": sorted(
                    k for k, t in self._down_until.items()
                    if t > time.monotonic()
                ),
            }

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self.directory is not None:
            self.directory.close()   # a later refresh reconnects
