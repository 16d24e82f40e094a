"""Directory consumers: the seed-failover client, the directory-backed
resolver and the PS client built from a lookup.

Port of ``distkeras_tpu/directory/client.py``. The only addresses a
participant needs are the directory's seeds (its primary and standbys).
PS shards, chain heads, serving replicas and shm segments are looked up,
so a joiner on another host builds its whole fan-out client from one
lookup, and a failover repoints every reader through the directory
instead of through per-worker resolvers wired by hand.
"""

from __future__ import annotations

import threading
from typing import Callable

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.resilience.retry import PSEndpoint, RetryPolicy

__all__ = [
    "DirectoryClient", "DirectoryEndpoint", "build_ps_client",
    "parse_seeds", "install_shm_rendezvous",
]


def parse_seeds(seeds) -> list[tuple[str, int]]:
    """Normalize directory seeds: ``[(host, port), ...]``, a single
    ``(host, port)``, or ``"host:port"`` strings (singly or in a
    list)."""
    if isinstance(seeds, str):
        seeds = [seeds]
    if isinstance(seeds, tuple) and len(seeds) == 2 \
            and isinstance(seeds[1], int):
        seeds = [seeds]
    out = []
    for s in seeds:
        if isinstance(s, str):
            host, _, port = s.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"directory seed {s!r} is not 'host:port'"
                )
            out.append((host, int(port)))
        else:
            host, port = s
            out.append((str(host), int(port)))
    if not out:
        raise ValueError("directory seeds must name at least one replica")
    return out


class DirectoryClient:
    """Thread-safe request/response client over the directory's seed
    list. Every op runs under a retry policy; a retryable failure (dead
    primary mid-frame, connection refused during a failover, an
    unpromoted standby's refusal) re-probes the seeds and lands on the
    replica advertising the **highest fence epoch** among the
    non-standbys — the promoted history always outranks a zombie, so the
    client can never be talked back onto a superseded primary."""

    def __init__(self, seeds, policy: RetryPolicy | None = None,
                 connect_timeout: float = 2.0):
        self.seeds = parse_seeds(seeds)
        self.policy = policy if policy is not None else RetryPolicy(
            max_attempts=80, base_delay=0.02, max_delay=0.3, deadline=30.0,
        )
        self.connect_timeout = float(connect_timeout)
        self._lock = threading.Lock()
        self._sock = None
        self._calls = 0
        self.reconnects = 0
        self.lookups = 0
        self.publishes = 0

    # -- plumbing ------------------------------------------------------------

    def _probe(self) -> "tuple[str, int] | None":
        """One pass over the seeds: ping each, prefer the serving
        replica with the highest fence epoch; None when nothing
        answers."""
        best = None
        for host, port in self.seeds:
            try:
                sock = networking.connect(host, port,
                                          timeout=self.connect_timeout)
                try:
                    sock.settimeout(self.connect_timeout)
                    networking.send_data(sock, {"action": "ping"})
                    info = networking.recv_data(sock)
                finally:
                    sock.close()
            except (OSError, EOFError, networking.ProtocolError):
                continue
            if not info.get("ok") or info.get("standby"):
                continue
            epoch = int(info.get("epoch", 0))
            if best is None or epoch > best[0]:
                best = (epoch, host, port)
        return None if best is None else (best[1], best[2])

    def _connect_locked(self) -> None:
        target = self._probe()
        if target is None:
            raise ConnectionRefusedError(
                f"no directory replica answering among {self.seeds}"
            )
        self._sock = networking.connect(target[0], target[1],
                                        timeout=self.connect_timeout)
        self._sock.settimeout(self.connect_timeout)
        self.reconnects += 1

    def _reset_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, msg: dict) -> dict:
        with self._lock:
            self._calls += 1
            salt = self._calls

        def op():
            with self._lock:
                if self._sock is None:
                    self._connect_locked()
                try:
                    networking.send_data(self._sock, msg)
                    reply = networking.recv_data(self._sock)
                except BaseException:
                    self._reset_locked()
                    raise
                if reply.get("error") == "standby":
                    # found a not-yet-promoted replica: weather — drop
                    # the conn so the retry re-probes for the primary
                    self._reset_locked()
                    raise networking.ProtocolError(
                        "directory replica is an unpromoted standby",
                        retryable=True,
                    )
                return reply

        return self.policy.run(op, salt=salt)

    # -- the consumer surface ------------------------------------------------

    def publish(self, role: str, key: str, host: str, port: int,
                epoch: int = 0, meta: dict | None = None,
                ttl: float | None = ...) -> dict:
        msg = {"action": "publish", "role": str(role), "key": str(key),
               "host": str(host), "port": int(port), "epoch": int(epoch),
               "meta": dict(meta or {})}
        if ttl is not ...:
            msg["ttl"] = None if ttl is None else float(ttl)
        self.publishes += 1
        return self._request(msg)

    def renew(self, role: str, key: str) -> dict:
        return self._request(
            {"action": "renew", "role": str(role), "key": str(key)}
        )

    def lookup(self, role: str, key: str | None = None) -> list[dict]:
        self.lookups += 1
        msg = {"action": "lookup", "role": str(role)}
        if key is not None:
            msg["key"] = str(key)
        return list(self._request(msg).get("entries", []))

    def withdraw(self, role: str, key: str, epoch: int = 0) -> dict:
        return self._request({
            "action": "withdraw", "role": str(role), "key": str(key),
            "epoch": int(epoch),
        })

    def membership(self) -> dict:
        return self._request({"action": "membership"})["membership"]

    def stats(self) -> dict:
        return self._request({"action": "stats"})["stats"]

    def shm_segments(self) -> list[dict]:
        """The shm rendezvous view (role ``shm``): which segments are
        live on this host, published by whoever
        minted them — see :func:`install_shm_rendezvous`."""
        return self.lookup("shm")

    def close(self) -> None:
        with self._lock:
            self._reset_locked()


class DirectoryEndpoint(PSEndpoint):
    """A :class:`PSEndpoint` whose truth lives in the directory: it
    caches the last resolved ``(host, port, epoch)`` like any resolver
    (so the hot path never touches the wire), and ``refresh()`` — which
    the resilient client calls on every reconnect — re-reads the entry
    through the directory, adopting it only when its fence epoch is at
    least the cached one (a resolver can never be walked backward onto
    a superseded primary by a stale read)."""

    def __init__(self, directory: DirectoryClient, role: str, key: str,
                 host: str = "", port: int = 0, epoch: int = 0):
        super().__init__(host, port, epoch=epoch)
        self.directory = directory
        self.role = str(role)
        self.key = str(key)
        self.refreshes = 0

    def refresh(self) -> bool:
        """Re-resolve through the directory; True when the cache moved.
        Raises only what the directory client's retry policy gave up on
        — the caller (a reconnect path) treats that as one more
        retryable failure."""
        entries = self.directory.lookup(self.role, self.key)
        self.refreshes += 1
        if not entries:
            return False
        entry = entries[0]
        with self._lock:
            if int(entry["epoch"]) < self._epoch:
                return False
            moved = (self._host != entry["host"]
                     or self._port != int(entry["port"])
                     or self._epoch != int(entry["epoch"]))
            self._host = entry["host"]
            self._port = int(entry["port"])
            self._epoch = int(entry["epoch"])
            if moved:
                self.updates += 1
        return moved

    def resolve(self):
        with self._lock:
            known = bool(self._host)
        if not known:
            self.refresh()
        return super().resolve()


def build_ps_client(directory, template, worker_id: int,
                    retry_policy: RetryPolicy | None = None,
                    heartbeat_interval: float | None = None,
                    pull_compression: str | None = None,
                    verify: bool = True):
    """Mint one worker's FULLY-WIRED PS client from a directory lookup
    alone, with no endpoint constructor arguments: an elastic joiner on
    another host discovers the fleet.

    ``directory`` is a :class:`DirectoryClient` or a seed list. The
    ``ps`` role's entries (``shard-00`` …) carry the fleet shape in
    their meta — ``num_shards``, ring ``digest``, ``vnodes``/``bound``
    — so the joiner derives the SAME :class:`~distkeras_tpu_torch.sharding.
    ring.ShardPlan` from its local ``template`` and fails fast
    (``ShardMapMismatchError``) if the fleet was sharded under a
    different plan. Every sub-client is a ``ResilientPSClient`` over a
    :class:`DirectoryEndpoint`, so a ``FencedEpochError`` or connect
    failure re-resolves through the directory with the existing
    retry/backoff triage.
    """
    from distkeras_tpu_torch.networking import ShardMapMismatchError
    from distkeras_tpu_torch.parameter_servers import ParameterServerClient
    from distkeras_tpu_torch.resilience.retry import ResilientPSClient

    if not isinstance(directory, DirectoryClient):
        directory = DirectoryClient(directory)
    entries = directory.lookup("ps")
    if not entries:
        raise ConnectionRefusedError(
            "directory holds no 'ps' registrations (fleet not started, "
            "or every shard's lease expired)"
        )
    meta = dict(entries[0].get("meta") or {})
    num_shards = int(meta.get("num_shards", len(entries)))
    by_key = {e["key"]: e for e in entries}

    def make_sub(sid: int):
        key = f"shard-{sid:02d}"
        entry = by_key.get(key)
        if entry is None:
            raise ConnectionRefusedError(
                f"directory names {sorted(by_key)} but the fleet "
                f"advertises {num_shards} shards — {key} is missing "
                f"(its lease expired and nothing re-registered)"
            )
        resolver = DirectoryEndpoint(
            directory, "ps", key, host=entry["host"],
            port=int(entry["port"]), epoch=int(entry["epoch"]),
        )

        def mk():
            host, port, epoch = resolver.resolve()
            return ParameterServerClient(
                host, port, worker_id,
                pull_compression=pull_compression, epoch=epoch,
            )

        return ResilientPSClient(
            mk, worker_id, policy=retry_policy,
            heartbeat_interval=heartbeat_interval, resolver=resolver,
        )

    if num_shards <= 1:
        return make_sub(0)

    from distkeras_tpu_torch.sharding.client import ShardedPSClient
    from distkeras_tpu_torch.sharding.ring import ShardPlan

    plan = ShardPlan(template, num_shards,
                     vnodes=int(meta.get("vnodes", 64)),
                     bound=float(meta.get("bound", 1.25)))
    want = meta.get("ring")
    if want is not None and want != plan.digest:
        raise ShardMapMismatchError(
            f"directory advertises ring {str(want)[:8]}… but this "
            f"template derives {plan.digest[:8]}… — the fleet was "
            f"sharded under a different plan"
        )
    client = ShardedPSClient(
        [make_sub(sid) for sid in range(num_shards)], plan, worker_id,
    )
    if verify:
        client.verify_shard_map()
    return client


def install_shm_rendezvous(directory: DirectoryClient,
                           ttl: float | None = None,
                           host: str | None = None) -> Callable[[], None]:
    """The shm rendezvous across processes: register every segment this
    process mints under the directory's ``shm`` role, so separate
    trainer processes on one host find each other's ring segments by
    name instead of passing them by hand. ``host`` names this host in the
    entries (default ``networking.determine_host_address()``). The
    ``mint_segment`` process registry stays the fallback when no
    directory is configured. Returns an uninstall callable."""
    from distkeras_tpu_torch import shm as _shm

    me = host if host is not None else networking.determine_host_address()

    def publish(name: str, size: int) -> None:
        directory.publish("shm", name, me, 0,
                          meta={"bytes": int(size)}, ttl=ttl)

    def withdraw(name: str) -> None:
        directory.withdraw("shm", name)

    _shm.set_rendezvous(publish, withdraw)

    def uninstall() -> None:
        _shm.clear_rendezvous(publish)

    return uninstall
