"""Trainer-side directory hosting: primary, standby, failover, wiring.

Port of ``distkeras_tpu/directory/host.py``. ``run_async_training`` with
``directory=True`` hosts the coordination service beside the PS fleet it
describes: one :class:`DirectoryServer` primary, a
:class:`StandbyDirectoryServer` fed by the apply-and-forward stream
(``directory_standby=``, on by default: an unreplicated directory would
be the one process whose loss loses the cluster), and a
:class:`~distkeras_tpu_torch.resilience.recovery.DirectoryFailoverSupervisor`
that promotes the standby (or restarts from the directory WAL, on the
original port) when the primary's lease lapses. It is the PS supervisor,
because the directory speaks the same admin wire surface.

Every PS shard registers as ``("ps", "shard-NN")`` with the fleet shape
in its meta; each shard's failover supervisor gets a publish callable,
so a promotion lands in the directory before the old primary is fenced
(publish-then-fence, see ``PSFailoverSupervisor``), and its healthy
pings renew the lease, so a dead shard's entry expires and the promoted
link's registration wins.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from distkeras_tpu_torch.directory.client import DirectoryClient
from distkeras_tpu_torch.directory.service import (
    DirectoryServer,
    StandbyDirectoryServer,
)
from distkeras_tpu_torch.resilience.retry import RetryPolicy

__all__ = ["HostedDirectory"]


class HostedDirectory:
    """Owns the hosted directory replicas, their failover supervision,
    and the registration/renewal plumbing for one training run."""

    def __init__(self, host: str = "127.0.0.1", wal_dir: str | None = None,
                 standby: bool = True, default_ttl: float = 10.0,
                 failover_timeout: float = 2.0, fault_plan=None,
                 snapshot_every: int = 64):
        self.host = host
        self.wal_dir = None if wal_dir is None else str(wal_dir)
        self.default_ttl = float(default_ttl)
        self.failover_timeout = float(failover_timeout)
        self.fault_plan = fault_plan
        self.snapshot_every = int(snapshot_every)
        self.primary = DirectoryServer(
            host=host, wal_dir=self.wal_dir,
            snapshot_every=snapshot_every, default_ttl=default_ttl,
            fault_plan=fault_plan,
        )
        self.standby = None
        if standby:
            self.standby = StandbyDirectoryServer(
                host=host,
                wal_dir=(None if self.wal_dir is None
                         else os.path.join(self.wal_dir, "standby")),
                snapshot_every=snapshot_every, default_ttl=default_ttl,
            )
        self.supervisor = None
        self._admin: DirectoryClient | None = None
        self._admin_lock = threading.Lock()
        self._registered: list[tuple[str, str]] = []
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.primary.initialize()
        self.primary.start()
        if self.standby is not None:
            self.standby.initialize()
            self.standby.start()
            self.primary.attach_standby(self.standby.host,
                                        self.standby.port)
        kill_chaos = (self.fault_plan is not None and getattr(
            self.fault_plan, "kill_directory_after_ops", None) is not None)
        if self.standby is not None or self.wal_dir is not None \
                or kill_chaos:
            from distkeras_tpu_torch.resilience.recovery import (
                DirectoryFailoverSupervisor,
            )
            from distkeras_tpu_torch.resilience.retry import PSEndpoint

            factory = None
            if self.wal_dir is not None:
                # restart-in-place binds the ORIGINAL primary port: the
                # seed list is every client's only bootstrap, so a
                # replacement on a fresh ephemeral port would be
                # unreachable by construction (SO_REUSEADDR makes the
                # rebind safe after the crash close)
                def factory():
                    new = DirectoryServer(
                        host=self.host, port=self.primary.port,
                        wal_dir=self.wal_dir,
                        snapshot_every=self.snapshot_every,
                        default_ttl=self.default_ttl,
                    )
                    new.initialize()
                    new.start()
                    return new

            self.supervisor = DirectoryFailoverSupervisor(
                PSEndpoint(self.primary.host, self.primary.port,
                           epoch=self.primary.fence_epoch),
                self.primary,
                standby=self.standby,
                restart_factory=factory,
                failover_timeout=self.failover_timeout,
            )
            self.supervisor.start()
        self._started = True

    @property
    def seeds(self) -> list[tuple[str, int]]:
        """The bootstrap addresses — the ONLY endpoints any participant
        needs by hand (primary first, then the standby)."""
        out = [(self.primary.host, self.primary.port)]
        if self.standby is not None:
            out.append((self.standby.host, self.standby.port))
        return out

    @property
    def active(self):
        if self.supervisor is not None:
            return self.supervisor.active
        return self.primary

    def admin(self) -> DirectoryClient:
        """The shared registration/renewal client — snappy policy: a
        renewal must never stall a supervisor's watch loop behind a
        directory that is itself failing over (the pending-publish
        retry delivers it later)."""
        with self._admin_lock:
            if self._admin is None:
                self._admin = DirectoryClient(
                    self.seeds,
                    policy=RetryPolicy(max_attempts=4, base_delay=0.02,
                                       max_delay=0.2, deadline=1.5),
                )
            return self._admin

    def client(self, policy: RetryPolicy | None = None) -> DirectoryClient:
        """A fresh consumer client over the seeds (workers, routers)."""
        return DirectoryClient(self.seeds, policy=policy)

    # -- registration --------------------------------------------------------

    def entry_ttl(self, supervised: bool) -> float | None:
        """Supervised entries lease-expire (their supervisor renews on
        every healthy ping); unsupervised ones are non-expiring — with
        nobody to renew them, a TTL would silently erase a healthy
        fleet."""
        if not supervised:
            return None
        return max(2.0 * self.failover_timeout, self.default_ttl)

    def register_shard(self, sid: int, srv, plan,
                       supervised: bool = True):
        """Publish one PS shard's entry and return the publish callable
        its failover supervisor uses for the atomic repoint AND as its
        per-ping lease renewal. ``plan=None`` registers an unsharded
        center as shard 0 of 1."""
        key = f"shard-{int(sid):02d}"
        if plan is None:
            meta: dict[str, Any] = {"num_shards": 1}
        else:
            meta = {
                "num_shards": int(plan.num_shards),
                "ring": plan.digest,
                "vnodes": int(plan.ring.vnodes),
                "bound": float(plan.bound),
            }
        ttl = self.entry_ttl(supervised)
        admin = self.admin()
        admin.publish("ps", key, srv.host, srv.port,
                      epoch=int(srv.fence_epoch), meta=meta, ttl=ttl)
        self._registered.append(("ps", key))

        def publish(host, port, epoch,
                    _admin=admin, _key=key, _meta=meta, _ttl=ttl):
            _admin.publish("ps", _key, host, port, epoch=int(epoch),
                           meta=_meta, ttl=_ttl)

        return publish

    def build_worker_client(self, template, worker_id: int,
                            retry_policy=None,
                            heartbeat_interval: float | None = None,
                            pull_compression: str | None = None):
        """One worker's fully-wired PS client minted from a directory
        lookup alone — the path elastic joiners (and every other worker)
        use, so discovery is exercised by construction, not only by
        chaos."""
        from distkeras_tpu_torch.directory.client import build_ps_client

        return build_ps_client(
            self.client(), template, worker_id,
            retry_policy=retry_policy,
            heartbeat_interval=heartbeat_interval,
            pull_compression=pull_compression,
        )

    # -- observability / teardown --------------------------------------------

    def membership(self) -> dict:
        return self.active.membership()

    def stats(self) -> dict:
        out = {
            "seeds": [list(s) for s in self.seeds],
            "primary": self.active.stats(),
            "registered": [list(k) for k in self._registered],
            "membership": self.active.membership(),
        }
        if self.supervisor is not None:
            out["failover"] = self.supervisor.stats()
        return out

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        seen = set()
        servers = [self.primary, self.standby]
        if self.supervisor is not None:
            servers.append(self.supervisor.active)
        for srv in servers:
            if srv is None or id(srv) in seen:
                continue
            seen.add(id(srv))
            try:
                srv.stop()
            except OSError:
                pass
        with self._admin_lock:
            if self._admin is not None:
                self._admin.close()
                self._admin = None
