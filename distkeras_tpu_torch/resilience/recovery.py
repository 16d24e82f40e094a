"""Automatic recovery: restart dead hogwild workers, fail the PS over.

Port of ``distkeras_tpu/resilience/recovery.py``:

- :class:`WorkerSupervisor` upgrades ``tolerate_worker_failures`` ("ignore
  the dead") to "restart the dead": a worker thread that dies with a
  tolerable error is relaunched, up to ``max_restarts`` times, from the
  best state available: its latest in-memory snapshot (taken at the last
  checkpoint barrier), else the ``fallback_restore`` hook's (the trainer's
  reads the newest on-disk checkpoint), else fresh per-worker state from a
  **fresh center pull**: the center kept training while the worker was
  down, so the restart re-bases onto the survivors' progress. The
  restarted worker renews its lease on its first window and its commits
  continue its client's seqno stream, so the server's dedup keeps folds
  exactly-once across the death. ``restart_delay`` is a cooldown before
  each relaunch; set above the lease timeout it makes eviction and
  re-admission visible in ``ps.stats()``.
- :class:`PSFailoverSupervisor` is the trainer-side lease on the PRIMARY
  parameter server: it pings the primary and, when the lease lapses,
  promotes the hot standby, or the next link of a replication chain (or
  restarts the server in place from its WAL), repoints every worker's :class:`~distkeras_tpu_torch.resilience.
  retry.PSEndpoint`, publishes the successor to the membership directory
  when one is wired (``publish=``), and fences the superseded primary.
- :class:`DirectoryFailoverSupervisor` is the same machinery pointed at
  the membership directory's primary (``directory/``).
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable


class RestartBudgetExceeded(RuntimeError):
    """A supervised worker died past its ``max_restarts`` budget and the
    failure was fatal (not tolerated, or no survivors). Raised by
    ``run_async_training``; carries the worker's last error as
    ``__cause__``."""


class PSFailoverSupervisor:
    """Trainer-side lease on the PRIMARY parameter server: ping it, and
    when its lease lapses, promote the replacement and repoint every
    worker's endpoint resolver.

    A daemon thread pings the primary over TCP every ``ping_interval``;
    ``failover_timeout`` seconds without a successful ping declares it
    dead and runs the failover, in this order (promote, publish, then
    fence):

    1. **promote** the first live link of the standby chain that was not
       promoted yet (``promote(epoch+1)``), else ``restart_factory()``: a
       fresh
       ``SocketParameterServer`` recovering ``(snapshot, wal)`` in place;
    2. **publish**: ``resolver.update(host, port, epoch+1)`` writes the
       endpoint and the epoch as one lock-guarded triple, and the
       membership directory's entry (with ``publish=``) gets the same
       triple, so every re-resolve from here on names the new primary at
       the new epoch;
    3. **fence** the superseded primary (best effort: it is usually dead
       and the connect is refused; an unconfirmed fence is retried every
       tick): commits carrying its epoch are refused from then on, so a
       zombie that wakes cannot fold into a history nobody serves, and
       the worker it bounces re-resolves onto the published successor.

    Restart-in-place shares the WAL directory with the old primary and so
    assumes the old server is really gone (the lapsed lease is the
    evidence); a suspected-but-alive primary is what the standby and
    fencing are for.

    It is also the chaos actor: when ``fault_plan`` carries
    ``kill_ps_after_commits``, the supervisor crash-stops the primary
    (``_crash()``: connections torn, no final fsync) once a ping reports
    its commit count past the threshold, then recovers from its own kill.
    (The trainer also installs the kill in the commit path itself,
    deterministic in commit count; whichever fires first takes it.)

    ``publish(host, port, epoch)`` writes this server's directory entry:
    at failover, between the repoint and the fence, and on every healthy
    ping as the entry's lease renewal, so a dead primary's registration
    ages out while a live one's never does. A publication that fails (the
    directory itself failing over) is kept and sent again each watch
    tick: the directory never stalls the failover it advertises.
    """

    #: what this supervisor watches (the directory's supervisor renames it)
    _kind = "parameter server"

    def __init__(self, resolver, primary, standby=None,
                 restart_factory: Callable[[], Any] | None = None,
                 failover_timeout: float = 2.0,
                 ping_interval: float | None = None,
                 fault_plan=None, max_failovers: int = 4,
                 publish: Callable[[str, int, int], None] | None = None):
        self.resolver = resolver
        self.active = primary
        # one replica or a chain, head first (sharding/): each failover
        # promotes the first live link not promoted yet, so a chain of k
        # survives k successive primary deaths before restart_factory
        if standby is None:
            self.standbys: list = []
        elif isinstance(standby, (list, tuple)):
            self.standbys = [s for s in standby if s is not None]
        else:
            self.standbys = [standby]
        self.standby = self.standbys[0] if self.standbys else None
        self.restart_factory = restart_factory
        self.failover_timeout = float(failover_timeout)
        self.ping_interval = (
            float(ping_interval) if ping_interval is not None
            else max(self.failover_timeout / 4.0, 0.02)
        )
        self.fault_plan = fault_plan
        self.max_failovers = int(max_failovers)
        self.failovers = 0
        self.failover_log: list[dict] = []
        self.failover_latency_s = 0.0
        self.wal_replay_s = 0.0
        self.error: BaseException | None = None
        # fences not CONFIRMED at failover time (the old primary was
        # unreachable: usually dead, possibly only stalled), retried every
        # watch tick so a stalled zombie is fenced the moment it answers
        self._pending_fences: list[tuple[str, int, int, dict]] = []
        self._publish_cb = publish
        self._pending_publish: tuple[str, int, int] | None = None
        self.publishes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="distkeras-ps-supervisor"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- the watch loop ------------------------------------------------------

    def _ping(self) -> dict | None:
        from distkeras_tpu_torch.parameter_servers import (
            ParameterServerClient,
        )

        host, port, _ = self.resolver.resolve()
        timeout = max(min(self.failover_timeout / 2.0, 1.0), 0.05)
        try:
            c = ParameterServerClient(host, port, -1,
                                      connect_timeout=timeout)
            try:
                return c.ping(timeout=timeout)
            finally:
                c._sock.close()
        except (OSError, EOFError):
            return None

    def _watch(self) -> None:
        try:
            deadline = time.monotonic() + self.failover_timeout
            while not self._stop.is_set():
                info = self._ping()
                now = time.monotonic()
                if info is not None and info.get("ok"):
                    deadline = now + self.failover_timeout
                    if self._publish_cb is not None \
                            and self._pending_publish is None:
                        # a healthy ping renews the directory lease (an
                        # identical re-publish is a renewal there); best
                        # effort: a directory failing over must not stall
                        # this loop
                        try:
                            self._publish_cb(*self.resolver.resolve())
                            self.publishes += 1
                        except Exception:  # noqa: BLE001
                            pass
                    plan = self.fault_plan
                    if plan is not None and plan.should_kill_ps(
                            int(info.get("num_updates", 0))):
                        # chaos: crash-stop the primary in-process; the
                        # next ping rounds discover the corpse
                        crash = getattr(self.active, "_crash", None)
                        if crash is not None:
                            plan.note_ps_kill()
                            crash()
                elif now >= deadline:
                    if self.failovers >= self.max_failovers:
                        raise RuntimeError(
                            f"parameter server unreachable after "
                            f"{self.failovers} failovers"
                        )
                    self._failover()
                    deadline = time.monotonic() + self.failover_timeout
                if self._pending_fences:
                    self._retry_pending_fences()
                if self._pending_publish is not None:
                    self._publish_now(*self._pending_publish)
                self._stop.wait(self.ping_interval)
        except BaseException as e:  # surfaced by run_async_training
            self.error = e

    def _try_fence(self, host: str, port: int, epoch: int) -> bool:
        from distkeras_tpu_torch.parameter_servers import (
            ParameterServerClient,
        )

        try:
            c = ParameterServerClient(host, port, -1, connect_timeout=0.5)
            c._sock.settimeout(1.0)
            try:
                c.fence(epoch)
                return True
            finally:
                c._sock.close()
        except (OSError, EOFError):
            return False

    def _retry_pending_fences(self) -> None:
        """Land every fence not confirmed at failover time: a stalled
        zombie primary is fenced the moment it answers again, and its
        workers' next commits raise ``FencedEpochError`` and re-resolve
        to the real primary."""
        still = []
        for host, port, epoch, entry in self._pending_fences:
            if self._try_fence(host, port, epoch):
                entry["fence_confirmed"] = True
            else:
                still.append((host, port, epoch, entry))
        self._pending_fences = still

    def _failover(self) -> None:
        from distkeras_tpu_torch.observability import trace as _trace

        with _trace.span("ps.failover"):
            self._failover_impl()

    def _publish_now(self, host: str, port: int, epoch: int) -> bool:
        """Write the directory entry (when wired); a failure keeps the
        triple, sent again each watch tick."""
        if self._publish_cb is None:
            return True
        try:
            self._publish_cb(host, int(port), int(epoch))
            self.publishes += 1
            self._pending_publish = None
            return True
        except Exception:  # noqa: BLE001
            self._pending_publish = (host, int(port), int(epoch))
            return False

    def _failover_impl(self) -> None:
        t0 = time.monotonic()
        old_host, old_port, old_epoch = self.resolver.resolve()
        epoch = old_epoch + 1
        # 1. promote the first live link not promoted yet: a crashed or
        # stopped link is skipped, since promoting a corpse would burn
        # every worker's retry deadline behind a closed listener. (A dead
        # middle link also cut its tail off the stream, so the chain
        # guards against successive HEAD deaths.)
        sb = next((s for s in self.standbys
                   if not s.promoted_ and not getattr(s, "crashed_", False)
                   and getattr(s, "_running", True)), None)
        if sb is not None:
            sb.promote(epoch)
            new = sb
            via = "standby"
        elif self.restart_factory is not None:
            new = self.restart_factory()
            new.fence(epoch)
            self.wal_replay_s += float(getattr(new, "wal_replay_s", 0.0))
            via = "restart"
        else:
            raise RuntimeError(
                f"primary {self._kind} died with no standby and no "
                f"restart factory (set ps_standby=True or ps_wal_dir)")
        # 2. publish: endpoint and epoch land as ONE triple in the
        # resolver and then in the directory, before any fence, so a
        # worker the fence bounces re-resolves straight onto the promoted
        # primary at the new epoch
        self.resolver.update(new.host, new.port, epoch)
        self.active = new
        published = self._publish_now(new.host, new.port, epoch)
        # 3. fence the superseded history (best effort now; retried)
        fence_confirmed = self._try_fence(old_host, old_port, epoch)
        latency = time.monotonic() - t0
        self.failovers += 1
        self.failover_latency_s += latency
        entry = {
            "via": via, "epoch": epoch, "latency_s": round(latency, 4),
            "wal_replay_s": round(
                float(getattr(new, "wal_replay_s", 0.0)), 4
            ),
            "fence_confirmed": fence_confirmed,
            "published": published,
        }
        self.failover_log.append(entry)
        if not fence_confirmed:
            self._pending_fences.append((old_host, old_port, epoch, entry))
        warnings.warn(
            f"{self._kind} failed over via {via} to "
            f"{new.host}:{new.port} (epoch {epoch}, "
            f"{latency * 1e3:.0f} ms)",
            stacklevel=2,
        )

    def stats(self) -> dict:
        return {
            "failovers": self.failovers,
            "failover_latency_s": round(self.failover_latency_s, 4),
            "wal_replay_s": round(self.wal_replay_s, 4),
            "publishes": self.publishes,
            "failover_log": list(self.failover_log),
        }


class DirectoryFailoverSupervisor(PSFailoverSupervisor):
    """The same lease watch, promotion and repoint pointed at a
    :class:`~distkeras_tpu_torch.directory.DirectoryServer`: the directory
    speaks the PS admin surface (``ping``, ``fence``, promotion of its
    standby), so watching it costs one subclass and no new protocol.
    Clients need no repoint: they probe the seed list and prefer the
    highest fence epoch, which the promotion just bumped."""

    _kind = "membership directory"


class WorkerSupervisor:
    """Run worker threads to completion, restarting tolerable deaths.

    ``workers`` are ``AsyncWorker``-shaped objects (``error``,
    ``snapshot``, ``restore``, ``start_epoch``, ``barrier`` attributes and
    a ``train`` entry point); ``args_of(i)`` returns the positional args
    for worker ``i``'s ``train``. ``fallback_restore(i)`` supplies a
    restore dict from outside (the on-disk checkpoint) when the worker
    died before its first in-memory snapshot.
    """

    def __init__(self, workers: list, args_of: Callable[[int], tuple],
                 max_restarts: int = 0, restart_delay: float = 0.0,
                 fallback_restore: Callable[[int], dict | None] | None = None,
                 poll_interval: float = 0.05):
        self.workers = workers
        self.args_of = args_of
        self.max_restarts = int(max_restarts)
        self.restart_delay = float(restart_delay)
        self.fallback_restore = fallback_restore
        self.poll_interval = float(poll_interval)
        self.restarts = [0] * len(workers)
        self.restart_log: list[dict] = []

    def _spawn(self, i: int) -> threading.Thread:
        t = threading.Thread(
            target=self.workers[i].train, args=self.args_of(i), daemon=True,
            name=f"distkeras-worker-{i}",
        )
        t.start()
        return t

    def _relaunch(self, i: int, err: BaseException) -> threading.Thread:
        w = self.workers[i]
        self.restarts[i] += 1
        # Latest snapshot wins; else the newest on-disk checkpoint's state
        # for this worker; else None -> the worker re-initializes from a
        # fresh center pull inside _train.
        restore = w.snapshot
        source = "snapshot"
        if restore is None and self.fallback_restore is not None:
            restore = self.fallback_restore(i)
            source = "checkpoint"
        if restore is None:
            source = "center-pull"
        epoch = getattr(w, "_epoch_done", None)
        w.restore = restore
        if restore is not None and epoch is not None:
            w.start_epoch = epoch + 1
        w.error = None
        # a death breaks the checkpoint barrier for everyone: the
        # restartee (like its tolerant peers) trains on barrier-free
        w.barrier = None
        self.restart_log.append({
            "worker": i, "attempt": self.restarts[i], "from": source,
            "error": f"{type(err).__name__}: {err}",
        })
        warnings.warn(
            f"worker {i} died ({type(err).__name__}: {err}); restart "
            f"{self.restarts[i]}/{self.max_restarts} from {source}",
            stacklevel=2,
        )
        if self.restart_delay > 0:
            time.sleep(self.restart_delay)
        return self._spawn(i)

    def run(self) -> list[BaseException | None]:
        """Start every worker, supervise until all are done (dead workers
        past budget stay dead). Returns the final per-worker errors."""
        threads = [self._spawn(i) for i in range(len(self.workers))]
        pending = set(range(len(self.workers)))
        while pending:
            for i in sorted(pending):
                threads[i].join(timeout=self.poll_interval)
                if threads[i].is_alive():
                    continue
                err = self.workers[i].error
                if err is not None and not isinstance(err, KeyboardInterrupt) \
                        and self.restarts[i] < self.max_restarts:
                    threads[i] = self._relaunch(i, err)
                    continue
                pending.discard(i)
        return [w.error for w in self.workers]

    def stats(self) -> dict:
        return {
            "restarts": int(sum(self.restarts)),
            "restart_log": list(self.restart_log),
        }
