"""The server side of the sharded center: N PS shards, chain replication
and per-shard failover.

Port of ``distkeras_tpu/sharding/group.py``. ``ShardedPSGroup`` owns, a
shard at a time, what ``run_async_training`` owns for one PS:

- one parameter server a shard (in-process, socket, shm or native C++),
  each holding its ``ShardPlan`` sub-center (a flat ``{path: leaf}`` dict)
  and running the unchanged fold, dedup, lease and WAL code: sharding
  multiplies servers, it does not fork their semantics;
- one WAL directory a shard under one root (``root/shard-00``, …), so a
  crashed shard restarts in place from its own log, and ``python -m
  distkeras_tpu_torch.resilience.wal verify <root>`` audits the whole
  center in one report;
- **chain replication** a shard (socket transport): ``chain_length − 1``
  replicas behind each primary, attached tail first so the stream has no
  gap. The primary streams every record to its first replica before the
  ACK; that replica applies it and forwards the same bytes down the chain.
  A 1-shard group with ``chain_length=2`` is the single hot standby;
- per-shard failover: one ``PSFailoverSupervisor`` a shard promotes down
  its chain (or restarts the shard from its WAL) and fences the dead
  shard's history with an epoch bump that repoints only that shard's
  endpoint resolver. The **shard-map epoch**, the sum of the shards'
  fencing epochs, rises with every failover.

The group stands in for a single ``ParameterServer`` where the trainer
reads one (``get_model``, ``get_ema``, ``num_updates``, ``mark_epoch``,
``stats``, ``stop``), reassembling the tree from each shard's ACTIVE
server (a promoted replica, not the corpse it replaced). With
``ema_decay`` every shard and replica folds the EMA of its sub-center per
commit (a replica through ``replay_record``, so a promoted link carries
it); a fold is leafwise, so the joined EMA is the single server's. With
a membership directory, ``start_supervision(directory=)`` registers every
shard primary there. ``metrics()`` exports the roll-up and the
per-shard series as one metrics registry.
"""

from __future__ import annotations

import os
from typing import Any

from distkeras_tpu_torch import utils
from distkeras_tpu_torch.sharding.client import ShardedPSClient
from distkeras_tpu_torch.sharding.ring import ShardPlan

Tree = Any

_SHARD_DIR = "shard-{sid:02d}"
_CHAIN_DIR = "chain-{j}"


def shard_wal_dir(root: str | None, sid: int) -> str | None:
    return None if root is None else os.path.join(
        root, _SHARD_DIR.format(sid=sid))


def chain_wal_dir(root: str | None, sid: int, j: int) -> str | None:
    base = shard_wal_dir(root, sid)
    return None if base is None else os.path.join(
        base, _CHAIN_DIR.format(j=j))


class ShardedPSGroup:
    """An N-shard parameter-server center with a chain and a failover
    supervisor a shard."""

    def __init__(self, center: Tree, rule, num_workers: int,
                 num_shards: int = 2, transport: str = "inprocess",
                 host: str = "127.0.0.1",
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_root: str | None = None, snapshot_every: int = 100,
                 wal_group_window: int = 8,
                 wal_group_interval: float = 0.25,
                 chain_length: int = 1,
                 vnodes: int = 64, bound: float = 1.25):
        if transport not in ("inprocess", "socket", "native", "shm"):
            raise ValueError(
                f"transport must be 'inprocess', 'socket', 'native', or "
                f"'shm', got {transport!r}")
        if chain_length < 1:
            raise ValueError(f"chain_length must be >= 1, got {chain_length}")
        if chain_length > 1 and transport != "socket":
            raise ValueError(
                "chain replication needs transport='socket' (replicas are "
                "socket servers; the in-process PS shares the trainer's fate "
                "and the native PS has no replication stream)")
        center = utils.tree_to_numpy(center)
        self.plan = ShardPlan(center, num_shards, vnodes=vnodes, bound=bound)
        self.rule = rule
        self.num_workers = int(num_workers)
        self.transport = transport
        self.host = host
        self.ema_decay = ema_decay
        self.lease_timeout = lease_timeout
        self.wal_root = None if wal_root is None else str(wal_root)
        self.snapshot_every = int(snapshot_every)
        self.wal_group_window = int(wal_group_window)
        self.wal_group_interval = float(wal_group_interval)
        self.chain_length = int(chain_length)
        self.servers: list = []       # each shard's primary
        self.chains: list[list] = []  # each shard's replicas, head first
        self.resolvers: list | None = None
        self.supervisors: list = []
        self._all_servers: list = []  # everything built, for stop()
        # the initial sub-centers stay: a shard's restart in place replays
        # its WAL onto this template
        self._sub_centers = [self.plan.shard_template(center, sid)
                             for sid in range(self.plan.num_shards)]
        for sid in range(self.plan.num_shards):
            sub = self._sub_centers[sid]
            srv = self._build_server(sub, sid,
                                     shard_wal_dir(self.wal_root, sid))
            self.servers.append(srv)
            self._all_servers.append(srv)
            chain = []
            for j in range(1, self.chain_length):
                rep = self._build_replica(
                    sub, sid, chain_wal_dir(self.wal_root, sid, j))
                chain.append(rep)
                self._all_servers.append(rep)
            self.chains.append(chain)

    # -- construction ------------------------------------------------------------

    def _server_kwargs(self, wal_dir: str | None) -> dict:
        return dict(ema_decay=self.ema_decay,
                    lease_timeout=self.lease_timeout, wal_dir=wal_dir,
                    snapshot_every=self.snapshot_every,
                    wal_group_window=self.wal_group_window,
                    wal_group_interval=self.wal_group_interval)

    def _build_server(self, sub_center: dict, sid: int,
                      wal_dir: str | None):
        kw = self._server_kwargs(wal_dir)
        if self.transport == "inprocess":
            from distkeras_tpu_torch.parameter_servers import ParameterServer

            srv = ParameterServer(sub_center, self.rule, self.num_workers,
                                  **kw)
        elif self.transport == "socket":
            from distkeras_tpu_torch.parameter_servers import (
                SocketParameterServer,
            )

            srv = SocketParameterServer(sub_center, self.rule,
                                        self.num_workers, host=self.host,
                                        port=0, **kw)
        elif self.transport == "shm":
            # each shard serves its sub-center over per-worker ring pairs:
            # the fan-out client opens one pair a (worker, shard)
            from distkeras_tpu_torch.shm import ShmParameterServer

            srv = ShmParameterServer(sub_center, self.rule, self.num_workers,
                                     **kw)
        else:
            from distkeras_tpu_torch.native_ps import (
                NativeSocketParameterServer,
            )

            srv = NativeSocketParameterServer(sub_center, self.rule,
                                              self.num_workers,
                                              host=self.host, port=0, **kw)
        srv.shard_info = self.plan.shard_info(sid)
        return srv

    def _build_replica(self, sub_center: dict, sid: int,
                       wal_dir: str | None):
        from distkeras_tpu_torch.parameter_servers import (
            StandbySocketParameterServer,
        )

        rep = StandbySocketParameterServer(
            sub_center, self.rule, self.num_workers, host=self.host, port=0,
            **self._server_kwargs(wal_dir))
        rep.shard_info = self.plan.shard_info(sid)
        return rep

    def initialize(self) -> None:
        for srv in self._all_servers:
            srv.initialize()

    def start(self) -> None:
        for srv in self._all_servers:
            if hasattr(srv, "start"):   # the in-process PS has no service
                srv.start()
        if self.transport == "native":
            for sid, srv in enumerate(self.servers):
                srv.set_shard_info(sid, self.plan.num_shards)
        # chain attachment TAIL FIRST (r_{k-1} → r_k, …, primary → r_1
        # last): every link exists before any record flows, and every
        # server starts from the same template, so the stream has no gap
        for sid, chain in enumerate(self.chains):
            for j in range(len(chain) - 1, 0, -1):
                chain[j - 1].attach_standby(self.host, chain[j].port)
            if chain:
                self.servers[sid].attach_standby(self.host, chain[0].port)

    # -- failover supervision ------------------------------------------------------

    def start_supervision(self, fault_plan=None,
                          failover_timeout: float = 2.0,
                          directory=None) -> None:
        """One ``PSFailoverSupervisor`` a shard (socket transport): promote
        down the shard's chain, else restart it from its WAL. A
        ``fault_plan`` carrying ``kill_ps_after_commits`` arms the kill in
        the commit path of the shard it names (``kill_shard_id``, default
        0).

        ``directory`` (a :class:`~distkeras_tpu_torch.directory.
        HostedDirectory`) registers every shard primary as ``("ps",
        "shard-NN")`` and hands each supervisor its publish callable:
        promotions land in the directory before the old primary is fenced,
        healthy pings renew the lease, and a dead shard's entry expires."""
        if self.transport != "socket":
            raise ValueError(
                "per-shard failover supervision needs transport='socket'")
        from distkeras_tpu_torch.resilience.recovery import (
            PSFailoverSupervisor,
        )
        from distkeras_tpu_torch.resilience.retry import PSEndpoint

        self.resolvers = [PSEndpoint(srv.host, srv.port,
                                     epoch=srv.fence_epoch)
                          for srv in self.servers]
        for sid, srv in enumerate(self.servers):
            factory = None
            if self.wal_root is not None:
                def factory(sid=sid):
                    new = self._build_server(
                        self._sub_centers[sid], sid,
                        shard_wal_dir(self.wal_root, sid))
                    new.initialize()
                    new.start()
                    return new
            publish = None
            if directory is not None:
                publish = directory.register_shard(sid, srv, self.plan)
            sup = PSFailoverSupervisor(
                self.resolvers[sid], srv, standby=self.chains[sid] or None,
                restart_factory=factory,
                failover_timeout=float(failover_timeout), publish=publish)
            sup.start()
            self.supervisors.append(sup)
        if fault_plan is not None and getattr(
                fault_plan, "kill_ps_after_commits", None) is not None:
            target = int(getattr(fault_plan, "kill_shard_id", 0) or 0)
            if not 0 <= target < self.plan.num_shards:
                raise ValueError(f"kill_shard_id {target} out of range for "
                                 f"{self.plan.num_shards} shards")
            victim = self.servers[target]

            def kill_hook(version, _ps=victim, _plan=fault_plan):
                if _plan.should_kill_ps(version):
                    _plan.note_ps_kill()
                    _ps._crash()

            victim.post_commit_hook = kill_hook

    def stop_supervision(self) -> None:
        for sup in self.supervisors:
            sup.stop()

    @property
    def supervisor_error(self):
        for sup in self.supervisors:
            if sup.error is not None:
                return sup.error
        return None

    def failover_stats(self) -> dict:
        per = [sup.stats() for sup in self.supervisors]
        return {
            "failovers": sum(s["failovers"] for s in per),
            "failover_latency_s": round(
                sum(s["failover_latency_s"] for s in per), 4),
            "wal_replay_s": round(sum(s["wal_replay_s"] for s in per), 4),
            "per_shard": per,
        }

    # -- the single-PS surface the trainer reads -------------------------------------

    @property
    def active_servers(self) -> list:
        if self.supervisors:
            return [sup.active for sup in self.supervisors]
        return list(self.servers)

    @property
    def map_epoch(self) -> int:
        """The shard-map epoch: the sum of the shards' fencing epochs,
        monotone under every failover."""
        if self.resolvers is not None:
            return sum(r.epoch for r in self.resolvers)
        return sum(int(srv.fence_epoch) for srv in self.servers)

    @property
    def num_updates(self) -> int:
        """Folds confirmed on EVERY shard (the min over shards), which the
        exactly-once oracle holds against the logical commits."""
        vals = [int(s.num_updates) for s in self.active_servers]
        return min(vals) if vals else 0

    @num_updates.setter
    def num_updates(self, v: int) -> None:
        """Seed every shard's fold count (a checkpoint resume)."""
        for s in self.active_servers:
            s.num_updates = int(v)

    @property
    def recovered_(self) -> bool:
        """Some shard recovered its state from a WAL."""
        return any(getattr(s, "recovered_", False)
                   for s in self.active_servers)

    def get_model(self) -> Tree:
        return self.plan.join([s.get_model() for s in self.active_servers])

    def get_ema(self) -> Tree | None:
        """The join of the shards' EMAs (None unless ``ema_decay``)."""
        if self.ema_decay is None:
            return None
        return self.plan.join([s.get_ema() for s in self.active_servers])

    def mark_epoch(self, epoch: int) -> None:
        """Log the training-epoch boundary on every shard that logs one
        (the checkpoint barrier quiesces the workers first, so all shards
        mark it at the same fold count)."""
        for s in self.active_servers:
            mark = getattr(s, "mark_epoch", None)
            if mark is not None:
                mark(int(epoch))

    def report_deploy_version(self, version: int) -> None:
        """Fan a read replica's published version to every shard (each
        prices its own ``deploy_lag_folds``; the roll-up takes the min
        version and the worst lag)."""
        for s in self.active_servers:
            report = getattr(s, "report_deploy_version", None)
            if report is not None:
                report(int(version))

    def stats(self, settle: bool = True) -> dict:
        """The shards' ``stats()`` rolled up (:func:`aggregate_ps_stats`);
        ``settle`` passes to each Python server's settling wait (the
        native server's counters are atomics and have none)."""
        from distkeras_tpu_torch.native_ps import NativeSocketParameterServer

        per = []
        for sid, s in enumerate(self.active_servers):
            d = dict(s.stats() if isinstance(s, NativeSocketParameterServer)
                     else s.stats(settle=settle))
            d["shard_id"] = sid
            d["shard_nbytes"] = self.plan.shard_nbytes[sid]
            per.append(d)
        out = aggregate_ps_stats(per)
        out["map_epoch"] = self.map_epoch
        out["ring"] = self.plan.digest
        return out

    def metrics(self):
        """The group's unified metrics surface: the aggregate roll-up plus
        per-shard ``shard``-labeled series, as a
        :class:`~distkeras_tpu_torch.observability.metrics.MetricsRegistry`
        ready for Prometheus/JSON export."""
        from distkeras_tpu_torch.observability.metrics import ps_metrics

        return ps_metrics(self.stats())

    def make_client(self, worker_id: int,
                    pull_compression: str | None = None,
                    retry_policy=None,
                    heartbeat_interval: float | None = None,
                    resilient: bool = False,
                    verify: bool = True) -> ShardedPSClient:
        """One worker's fan-out client: a transport client a shard
        (resolver-aware under supervision), each wrapped, when
        ``resilient``, in a ``ResilientPSClient`` with its OWN seqno
        stream (exactly-once is a per-shard property). With ``verify``
        the shard-map handshake runs before first use (every transport
        but the in-process one, which has no wiring to get wrong)."""
        subs = []
        for sid in range(self.plan.num_shards):
            mk = self._client_factory(sid, worker_id, pull_compression)
            if resilient:
                from distkeras_tpu_torch.resilience.retry import (
                    ResilientPSClient,
                )

                subs.append(ResilientPSClient(
                    mk, worker_id, policy=retry_policy,
                    heartbeat_interval=heartbeat_interval,
                    resolver=(self.resolvers[sid]
                              if self.resolvers is not None else None)))
            else:
                subs.append(mk())
        client = ShardedPSClient(subs, self.plan, worker_id)
        if verify and self.transport != "inprocess":
            try:
                client.verify_shard_map()
            except BaseException:
                client.close()
                raise
        return client

    def _client_factory(self, sid: int, worker_id: int,
                        pull_compression: str | None):
        if self.transport == "inprocess":
            from distkeras_tpu_torch.workers import _BoundPS

            return lambda: _BoundPS(self.servers[sid], worker_id,
                                    pull_compression=pull_compression)
        if self.transport == "socket":
            from distkeras_tpu_torch.parameter_servers import (
                ParameterServerClient,
            )

            def mk():
                if self.resolvers is not None:
                    host, port, epoch = self.resolvers[sid].resolve()
                else:
                    host, port, epoch = (self.servers[sid].host,
                                         self.servers[sid].port, None)
                return ParameterServerClient(
                    host, port, worker_id,
                    pull_compression=pull_compression, epoch=epoch)

            return mk
        if self.transport == "shm":
            from distkeras_tpu_torch.shm import ShmPSClient

            # each call mints a fresh ring pair against the shard's
            # server: what a resilient reconnect needs
            return lambda: ShmPSClient(self.servers[sid], worker_id,
                                       pull_compression=pull_compression)
        from distkeras_tpu_torch.native_ps import NativePSClient

        def mk_native():
            srv = self.servers[sid]
            return NativePSClient(srv.host, srv.port, worker_id, srv.spec,
                                  pull_compression=pull_compression)

        return mk_native

    def stop(self) -> None:
        self.stop_supervision()
        servers = list(self._all_servers)
        servers.extend(sup.active for sup in self.supervisors)
        for srv in {id(s): s for s in servers}.values():
            try:
                srv.stop()
            except OSError:
                pass

    def initialize_and_start(self) -> None:
        """``initialize()`` then ``start()``, as a single server is
        brought up."""
        self.initialize()
        self.start()


def aggregate_ps_stats(per_shard: list[dict]) -> dict:
    """N shards' ``stats()`` rolled into one summary beside the raw list.

    The roll-up keeps the single-PS key set: counters and rates summed,
    gauges maxed (every shard leases the same workers), the lock's mean
    hold re-derived from the totals; the per-shard dicts stay under
    ``per_shard``, so no single-PS key collides with a shard's."""
    summed = (
        "pulls", "compressed_pulls", "commits", "bytes_in", "bytes_out",
        "center_lock_acquires", "center_lock_wait_ns",
        "center_lock_hold_ns", "dup_commits", "heartbeats",
        "worker_retries", "fenced_commits", "wal_records", "wal_fsyncs",
        "pulls_per_sec", "commits_per_sec",
        # a fan-out exchange is one fused round trip a shard
        "fused_exchanges", "exchange_rtts", "batched_folds",
    )
    # membership counters are maxed like the lease gauges: every shard
    # sees the same joins and drains through the fan-out
    maxed = ("active_workers", "evicted_workers", "elapsed_s",
             "wal_group_max", "pool_size", "joined_workers",
             "preempted_workers", "drain_timeouts")
    out: dict = {"num_shards": len(per_shard)}
    for k in summed:
        out[k] = sum(s.get(k, 0) for s in per_shard)
    for k in maxed:
        out[k] = max((s.get(k, 0) for s in per_shard), default=0)
    updates = [int(s.get("num_updates", 0)) for s in per_shard]
    # min: folds confirmed on every shard (the exactly-once oracle's);
    # max beside it shows a mid-scatter gap
    out["num_updates"] = min(updates) if updates else 0
    out["num_updates_max"] = max(updates) if updates else 0
    # a served snapshot exists only at a version every shard published:
    # the deployed version is the min, the lag the worst shard's
    deploys = [int(s.get("deploy_version", 0)) for s in per_shard]
    out["deploy_version"] = min(deploys) if deploys else 0
    out["deploy_lag_folds"] = max(
        (int(s.get("deploy_lag_folds", 0)) for s in per_shard), default=0)
    acq = out["center_lock_acquires"]
    out["center_lock_mean_hold_ns"] = (
        out["center_lock_hold_ns"] // acq if acq else 0)
    out["per_shard"] = list(per_shard)
    return out
