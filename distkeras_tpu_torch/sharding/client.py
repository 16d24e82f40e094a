"""The worker's sharded PS client: fan out, reassemble, stay exactly-once.

Port of ``distkeras_tpu/sharding/client.py``. ``ShardedPSClient`` presents
the single-PS client surface the workers speak (``pull``, ``commit``,
``exchange``, ``heartbeat``, ``maybe_heartbeat``, ``deregister``,
``close``) over one transport client a shard. Every pull reaches every
shard (the worker needs the whole tree) and every commit scatters to every
shard (a window's delta has leaves everywhere), which keeps each shard's
DynSGD staleness equal to the single PS's τ: each shard's ``num_updates``
and this worker's pull version there advance with the global schedule.

The fan-out runs on a thread pool of one thread a shard, so an N-shard
pull costs about one shard's latency. Exactly-once under retries is a
per-shard property: each sub-client may be a ``ResilientPSClient`` with
its own seqno stream against its own shard's dedup table, so a lost ACK
on one shard replays there only.

``verify_shard_map`` checks that each sub-client is wired to the shard it
stands for (shard id, shard count and the plan's ring digest); a
mis-wired endpoint raises the non-retryable
:class:`~distkeras_tpu_torch.networking.ShardMapMismatchError`. An elastic
live join and a preemption drain fan out to every shard, so each shard
counts the same membership events.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from distkeras_tpu_torch.networking import ShardMapMismatchError
from distkeras_tpu_torch.sharding.ring import ShardPlan

Tree = Any

_NO_SEQ = ("ShardedPSClient assigns per-shard seqnos internally; wrap the "
           "shard clients in ResilientPSClient instead of passing seq")


class ShardedPSClient:
    """Fan-out proxy over one transport client a shard."""

    def __init__(self, clients: list, plan: ShardPlan, worker_id: int):
        if len(clients) != plan.num_shards:
            raise ValueError(f"{len(clients)} shard clients for a "
                             f"{plan.num_shards}-shard plan")
        self._clients = list(clients)
        self.plan = plan
        self.worker_id = int(worker_id)
        self._pool = ThreadPoolExecutor(
            max_workers=plan.num_shards,
            thread_name_prefix=f"dk-shard-w{worker_id}")
        self._closed = False
        self._lock = threading.Lock()

    def _scatter(self, op: Callable[[Any, int], Any]) -> list:
        """``op(client, sid)`` on every shard at once; wait for every one
        to settle (a failed shard must leave no sibling in flight, racing
        this worker's next call), then raise the first failure."""
        futs = [self._pool.submit(op, c, sid)
                for sid, c in enumerate(self._clients)]
        results, first_err = [], None
        for fut in futs:
            try:
                results.append(fut.result())
            except BaseException as e:  # noqa: BLE001 (raised below)
                results.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    # -- the worker-facing surface ---------------------------------------------

    def pull(self, worker_id: int | None = None) -> Tree:
        # each sub-client decodes its own reply (int8 pulls too), so the
        # parts arrive as plain {path: leaf} dicts
        return self.plan.join(self._scatter(lambda c, sid: c.pull()))

    def commit(self, worker_id: int | None, payload: Tree,
               seq: int | None = None) -> None:
        if seq is not None:
            raise ValueError(_NO_SEQ)
        parts = self.plan.split(payload)
        self._scatter(lambda c, sid: c.commit(self.worker_id, parts[sid]))

    def exchange(self, worker_id: int | None, payload: Tree,
                 seq: int | None = None, lag: bool = False) -> Tree:
        """Fused commit and pull fanned to every shard: each folds its part
        and answers with its fresh sub-center in one round trip. Each
        shard prices ``lag`` from its own previous pull version, so each
        shard's τ matches the single PS's when pipelined too."""
        if seq is not None:
            raise ValueError(_NO_SEQ)
        parts = self.plan.split(payload)

        def op(c, sid):
            ex = getattr(c, "exchange", None)
            if ex is not None:
                return ex(self.worker_id, parts[sid], lag=lag)
            c.commit(self.worker_id, parts[sid])
            return c.pull()

        return self.plan.join(self._scatter(op))

    def heartbeat(self, retries: int = 0) -> bool:
        out = self._scatter(
            lambda c, sid: (c.heartbeat(retries=retries)
                            if hasattr(c, "heartbeat") else True))
        return all(bool(v) for v in out)

    def maybe_heartbeat(self) -> bool:
        """Piggybacked lease renewal: each shard's sub-client rate-limits
        its own heartbeat (every shard runs its own lease registry)."""
        out = self._scatter(
            lambda c, sid: (c.maybe_heartbeat()
                            if hasattr(c, "maybe_heartbeat") else False))
        return any(bool(v) for v in out)

    def deregister(self) -> None:
        self._scatter(lambda c, sid: (c.deregister()
                                      if hasattr(c, "deregister") else None))

    def join(self) -> dict | None:
        """Live join on every shard (the pool is one global membership;
        each shard counts the same joins, as it leases the same workers).
        Returns shard 0's admission record."""
        out = self._scatter(
            lambda c, sid: c.join() if hasattr(c, "join") else None)
        return out[0] if out else None

    def drain(self, timeout: bool = False) -> None:
        """Preemption drain fanned out to every shard: each retires this
        worker's dedup seqno and counts the drain in its own stats."""
        self._scatter(lambda c, sid: (c.drain(timeout=timeout)
                                      if hasattr(c, "drain") else None))

    def set_timeout(self, seconds: float | None) -> None:
        for c in self._clients:
            if hasattr(c, "set_timeout"):
                c.set_timeout(seconds)
            elif hasattr(c, "_sock"):
                c._sock.settimeout(seconds)

    def verify_shard_map(self) -> None:
        """The handshake: every sub-client must be wired to the shard it
        stands for under THIS plan. A transport without a shard channel
        (the in-process proxy) passes."""
        expect = self.plan

        def check(c, sid):
            info = None
            if hasattr(c, "shard_map"):
                info = c.shard_map()
            elif hasattr(c, "shard_info"):
                info = c.shard_info()
            if info is None:
                return  # an unsharded server or an in-process proxy
            if (int(info.get("shard_id", -1)) != sid
                    or int(info.get("num_shards", 0)) != expect.num_shards
                    or info.get("ring") not in (None, expect.digest)):
                raise ShardMapMismatchError(
                    f"endpoint for shard {sid} advertises "
                    f"{info.get('shard_id')}/{info.get('num_shards')} (ring "
                    f"{str(info.get('ring'))[:8]}…), expected "
                    f"{sid}/{expect.num_shards} (ring {expect.digest[:8]}…)")

        self._scatter(check)

    # -- what run_async_training reads ------------------------------------------

    @property
    def seq(self) -> int:
        """Logical commits confirmed on every shard (the exactly-once
        oracle's count for this worker): the min over shards, since a
        commit that failed on one shard mid-scatter is not confirmed."""
        vals = [int(getattr(c, "seq", 0)) for c in self._clients]
        return min(vals) if vals else 0

    @property
    def retries(self) -> int:
        return sum(int(getattr(c, "retries", 0)) for c in self._clients)

    @property
    def reconnects(self) -> int:
        return sum(int(getattr(c, "reconnects", 0)) for c in self._clients)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._scatter(lambda c, sid: c.close())
        finally:
            self._pool.shutdown(wait=True)
