"""Weight streaming: serving-tier read replicas of the training center.

Port of ``distkeras_tpu/deploy/stream.py``; the center and every snapshot
are host numpy trees (the parameter server's), copied with numpy.

The training PS already streams every applied record (commit / pull /
dereg / evict / fence / epoch) to its hot standby BEFORE the client's
ACK, and a standby chain-link forwards the same raw frames to its own
successor (``StandbySocketParameterServer._serve_replication``). A
:class:`ReadReplica` is the serving tier's subscriber to that stream: it
listens like a standby, accepts the primary's ``replicate_stream``
handshake, applies each record through the one shared
``wal.replay_record`` (so its center is bit-identical to the trainer's at
every version), and forwards the raw frames to its successor: N serving
hosts chain off one stream without multiplying the trainer's send cost.

Serving must NOT consume the stream per-commit: a model swap costs a
prefill storm (every in-flight sequence either drains or re-prefills) and
at async-SGD fold rates that would swap thousands of times a second.
:class:`WeightStreamer` therefore *materializes versioned snapshots* only
at fold-count boundaries (``snapshot_every``) and at training-epoch marks
(``REC_EPOCH``, logged by the trainer's barrier), and for a sharded
center it assembles the consistent cut — every shard captured at the SAME
version ``F`` — before publishing. Published versions are reported back
to the training PS, which exposes the distance as
``stats()['deploy_lag_folds']``.

Epoch-mark snapshots double as *elastic epoch-barrier checkpoints*: with
``checkpoint_dir`` set, the store writes the exact resume payload
``run_async_training`` consumes (center + epoch, worker list empty → the
``warn_elastic_resume`` center-only path), closing the "elastic runs are
resume-only" gap.
"""

from __future__ import annotations

import pickle
import queue
import socket
import threading
from typing import Callable

import numpy as np

from distkeras_tpu_torch import networking, utils
from distkeras_tpu_torch.observability import trace as _trace

__all__ = [
    "ModelSnapshot",
    "ReadReplica",
    "SnapshotStore",
    "WeightStreamer",
]


def _tree_copy(tree):
    return utils.host_tree_map(np.copy, tree)


class ModelSnapshot:
    """One materialized serving model: ``(version, epoch, tree)``.

    ``version`` is the training center's fold count at the cut;
    ``epoch`` is the training epoch for epoch-boundary cuts (None for
    plain fold-count cuts). Immutable by convention — the engine swaps
    the tree in whole, never mutates it.
    """

    __slots__ = ("version", "epoch", "tree")

    def __init__(self, version: int, tree, epoch: int | None = None):
        self.version = int(version)
        self.epoch = None if epoch is None else int(epoch)
        self.tree = tree

    def __repr__(self) -> str:  # journal/debug friendliness
        ep = "" if self.epoch is None else f", epoch={self.epoch}"
        return f"ModelSnapshot(version={self.version}{ep})"


class SnapshotStore:
    """Bounded version → :class:`ModelSnapshot` map with subscribers.

    ``publish`` is monotone (an older-or-equal version is dropped — the
    sharded assembler may race a fold-count cut against an epoch cut at
    the same version) and notifies subscribers OUTSIDE the lock.

    With ``checkpoint_dir`` set, every epoch-boundary snapshot also
    lands on disk as a resumable checkpoint in ``run_async_training``'s
    payload shape (``workers=[]`` → the elastic center-only resume path
    with ``warn_elastic_resume``) — the epoch-barrier checkpoint elastic
    runs previously never got.
    """

    def __init__(self, keep: int = 4, checkpoint_dir: str | None = None,
                 checkpoint_keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._mu = threading.Lock()
        self._snaps: dict[int, ModelSnapshot] = {}
        self._latest = 0
        self.keep = int(keep)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_keep = int(checkpoint_keep)
        self._subs: list[Callable[[ModelSnapshot], None]] = []
        self.published = 0
        self.checkpoints_written = 0

    def subscribe(self, fn: Callable[[ModelSnapshot], None]) -> None:
        """Call ``fn(snapshot)`` after every accepted publish (outside
        the store lock; exceptions are swallowed per-subscriber)."""
        with self._mu:
            self._subs.append(fn)

    def publish(self, version: int, tree, epoch: int | None = None) -> bool:
        snap = ModelSnapshot(version, tree, epoch=epoch)
        with self._mu:
            if snap.version <= self._latest:
                return False
            self._snaps[snap.version] = snap
            self._latest = snap.version
            while len(self._snaps) > self.keep:
                del self._snaps[min(self._snaps)]
            self.published += 1
            subs = list(self._subs)
        if self.checkpoint_dir is not None and snap.epoch is not None:
            self._write_checkpoint(snap)
        for fn in subs:
            try:
                fn(snap)
            except Exception:  # a broken subscriber must not stall the cut
                pass
        return True

    def _write_checkpoint(self, snap: ModelSnapshot) -> None:
        from distkeras_tpu_torch.checkpoint import save_checkpoint

        payload = {
            # worker state is per-process optimizer slots the serving
            # tier never sees: empty list → the resume path warns
            # (warn_elastic_resume) and restarts workers fresh from the
            # center — exactly elastic resume's defined semantics
            "workers": [],
            "center": snap.tree,
            "num_updates": snap.version,
            "epoch": snap.epoch,
        }
        try:
            save_checkpoint(self.checkpoint_dir, payload, snap.version,
                            keep=self.checkpoint_keep)
            self.checkpoints_written += 1
        except OSError:
            pass  # a full/readonly disk degrades durability, not serving

    def latest(self) -> ModelSnapshot | None:
        with self._mu:
            snap = self._snaps.get(self._latest)
        return snap

    def get(self, version: int) -> ModelSnapshot | None:
        with self._mu:
            return self._snaps.get(int(version))

    def versions(self) -> list[int]:
        with self._mu:
            return sorted(self._snaps)


class ReadReplica:
    """One shard's serving-side subscriber to the replication stream.

    Listens like a hot standby: the TRAINING side connects out to
    ``(host, port)`` (``attach_standby`` on the primary or on a chain
    tail) and sends the ``replicate_stream`` handshake — a full base
    state — then raw header+body record frames. Records are applied
    through ``wal.replay_record`` under one apply lock, so the replica's
    center is bit-identical to the trainer's at every version, and
    forwarded to this replica's own successor (``attach_successor``) so
    several serving hosts share one stream.

    Construct with the TRAINER's merge rule and *configured* worker
    count — the fold arithmetic prices staleness from them, and a
    mismatch silently diverges the replayed center.
    """

    def __init__(self, rule, num_workers: int, *, ema_decay: float | None = None,
                 host: str = "127.0.0.1", shard_id: int = 0,
                 on_apply: Callable | None = None, backlog: int = 4):
        self.rule = rule
        self.num_workers = int(num_workers)
        self.ema_decay = ema_decay
        self.shard_id = int(shard_id)
        self.on_apply = on_apply
        self._lock = threading.Lock()  # state + successor sock + counters
        self._state: dict | None = None
        self._streaming = False
        self._records = 0
        self._successor_sock = None
        self._successor_addr: tuple[str, int] | None = None
        self._n_forward_drops = 0
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(backlog)
        self.host, self.port = self._srv.getsockname()[:2]
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"read-replica-{self.shard_id}")
        t.start()
        self._threads.append(t)

    # -- stream side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _handle(self, conn) -> None:
        try:
            while True:
                msg = networking.recv_data(conn)
                action = msg.get("action")
                if action == "replicate_stream":
                    self._serve_stream(conn, msg)
                    break  # stream EOF/error ends the connection
                elif action == "ping":
                    with self._lock:
                        v = (self._state or {}).get("num_updates", 0)
                    networking.send_data(conn, {
                        "ok": True, "num_updates": v, "read_replica": True,
                        "shard": self.shard_id,
                    })
                elif action in ("stop", "bye"):
                    break
                else:
                    networking.send_data(
                        conn, {"ok": False, "error": "read replica"}
                    )
        except (ConnectionError, EOFError, OSError):
            pass
        except pickle.UnpicklingError:
            pass
        finally:
            conn.close()

    def _serve_stream(self, conn, msg) -> None:
        from distkeras_tpu_torch.resilience import wal as _wal

        with self._lock:
            self._state = dict(msg["state"])
            self._streaming = True
            # a successor registered before the base arrived attaches now,
            # under the same lock — it misses no record
            if self._successor_addr and self._successor_sock is None:
                self._connect_successor_locked()
        networking.send_data(conn, {"ok": True})
        hdr = _wal._HDR
        try:
            while True:
                head = networking._recv_exact(conn, hdr.size)
                _, _, ln = hdr.unpack(head)
                body = networking._recv_exact(conn, ln, expected=ln)
                recs = list(_wal.iter_records(head + body))
                if not recs:
                    raise networking.ProtocolError(
                        "corrupt replication record", retryable=False
                    )
                rec_type = recs[0][0]
                with self._lock:
                    self._records += 1
                    with _trace.span("deploy.apply",
                                     args={"shard": self.shard_id}):
                        _wal.replay_record(
                            self._state, rec_type, recs[0][1],
                            self.rule, self.num_workers, self.ema_decay,
                        )
                    self._forward_locked(head, body)
                    if self.on_apply is not None:
                        self.on_apply(self, rec_type, self._state)
        finally:
            with self._lock:
                self._streaming = False

    # -- chain side ----------------------------------------------------------

    def attach_successor(self, host: str, port: int,
                         timeout: float = 10.0) -> None:
        """Chain another read replica behind this one. Before the base
        state arrives the address is parked and the handshake happens
        inside the base install (gap-free); after it, the successor gets
        this replica's CURRENT state as its base under the apply lock."""
        with self._lock:
            self._successor_addr = (host, int(port))
            self._successor_timeout = float(timeout)
            if self._state is not None:
                self._connect_successor_locked()

    def _connect_successor_locked(self) -> None:
        host, port = self._successor_addr
        timeout = getattr(self, "_successor_timeout", 10.0)
        sock = networking.connect(host, port, timeout=timeout)
        sock.settimeout(timeout)
        base = {k: v for k, v in self._state.items()
                if k not in ("replayed", "_flat")}
        networking.send_data(
            sock, {"action": "replicate_stream", "state": base}
        )
        reply = networking.recv_data(sock)
        if not reply.get("ok"):
            sock.close()
            raise ConnectionError(
                f"read replica at {host}:{port} refused the stream: {reply}"
            )
        sock.settimeout(5.0)  # bounded per-record forward
        self._successor_sock = sock

    def _forward_locked(self, head: bytes, body: bytes) -> None:
        sock = self._successor_sock
        if sock is None:
            return
        try:
            with _trace.span("deploy.forward"):
                sock.sendall(head)
                sock.sendall(body)
        except OSError:
            self._successor_sock = None
            self._n_forward_drops += 1
            try:
                sock.close()
            except OSError:
                pass

    # -- reads ---------------------------------------------------------------

    @property
    def num_updates(self) -> int:
        with self._lock:
            return int((self._state or {}).get("num_updates", 0))

    @property
    def epoch_mark(self) -> int | None:
        with self._lock:
            mark = (self._state or {}).get("epoch_mark")
        return None if mark is None else int(mark)

    def snapshot_center(self):
        """``(version, center copy)`` at a consistent instant (under the
        apply lock — no record lands mid-copy)."""
        with self._lock:
            if self._state is None:
                return 0, None
            return (int(self._state["num_updates"]),
                    _tree_copy(self._state["center"]))

    def stats(self) -> dict:
        with self._lock:
            return {
                "shard_id": self.shard_id,
                "records": self._records,
                "num_updates": int((self._state or {}).get("num_updates", 0)),
                "streaming": self._streaming,
                "forward_drops": self._n_forward_drops,
            }

    def stop(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            sock = self._successor_sock
            self._successor_sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class WeightStreamer:
    """One serving host's streaming attachment: per-shard read replicas +
    the snapshot cut policy + the consistent-cut assembler.

    - ``snapshot_every``: cut a snapshot when a shard's fold count
      crosses a multiple of it (0 disables fold-count cuts).
    - training-epoch marks (``REC_EPOCH``) always cut, and carry the
      epoch into the snapshot (and the elastic checkpoint, if a
      ``checkpoint_dir`` is set on the store).
    - a sharded center publishes only when EVERY shard was captured at
      the same version ``F`` (each shard passes through ``F`` exactly
      once, so the captures exist; one slow shard delays the cut, which
      is exactly what ``deploy_lag_folds`` then shows).

    Captures happen under the per-shard apply lock (an O(shard) copy at
    snapshot cadence); assembly/publish/checkpoint run on a background
    publisher thread so the apply loop — and the chain forward behind it
    — never stalls on a join or a disk write.
    """

    def __init__(self, rule, num_workers: int, *, plan=None,
                 ema_decay: float | None = None, snapshot_every: int = 50,
                 keep: int = 4, store: SnapshotStore | None = None,
                 checkpoint_dir: str | None = None,
                 host: str = "127.0.0.1",
                 report: Callable[[int], None] | None = None):
        if snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}"
            )
        self.plan = plan
        self.snapshot_every = int(snapshot_every)
        self.store = store if store is not None else SnapshotStore(
            keep=keep, checkpoint_dir=checkpoint_dir
        )
        self._report = report
        n = 1 if plan is None else int(plan.num_shards)
        self.replicas = [
            ReadReplica(rule, num_workers, ema_decay=ema_decay, host=host,
                        shard_id=sid, on_apply=self._on_apply)
            for sid in range(n)
        ]
        # version → {sid: (tree, epoch|None)} pending shard captures
        self._mu = threading.Lock()
        self._pending: dict[int, dict[int, tuple]] = {}
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._publisher = threading.Thread(
            target=self._publish_loop, daemon=True, name="weight-streamer"
        )
        self._publisher.start()

    # -- wiring --------------------------------------------------------------

    def attach_to(self, ps) -> None:
        """Subscribe to ``ps``'s replication stream. ``ps`` is a single
        PS (plain or standby chain tail) or a ``ShardedPSGroup`` — for a
        group, each shard's chain TAIL (or primary, chainless groups)
        attaches its matching replica. Also adopts ``ps`` as the deploy
        report sink unless one was given at construction."""
        chains = getattr(ps, "chains", None)
        servers = getattr(ps, "servers", None)
        if chains is not None and servers is not None:  # sharded group
            if len(self.replicas) != len(servers):
                raise ValueError(
                    f"streamer built for {len(self.replicas)} shard(s) but "
                    f"the group has {len(servers)}"
                )
            for sid, rep in enumerate(self.replicas):
                tail = chains[sid][-1] if chains and chains[sid] \
                    else servers[sid]
                tail.attach_standby(rep.host, rep.port)
        else:
            if len(self.replicas) != 1:
                raise ValueError(
                    "sharded streamer attached to an unsharded server"
                )
            if getattr(ps, "has_standby", False):
                raise ValueError(
                    "the server's replica slot is taken (hot standby) — "
                    "attach the streamer to the chain tail instead"
                )
            ps.attach_standby(self.replicas[0].host, self.replicas[0].port)
        if self._report is None:
            sink = getattr(ps, "report_deploy_version", None)
            if sink is not None:
                self._report = sink

    def chain_to(self, other: "WeightStreamer") -> None:
        """Forward this host's stream to ``other`` (per matching shard)
        — N serving hosts share the trainer's single replica slot."""
        if len(other.replicas) != len(self.replicas):
            raise ValueError("chained streamers must have equal shard counts")
        for rep, succ in zip(self.replicas, other.replicas):
            rep.attach_successor(succ.host, succ.port)
        if other._report is None:
            other._report = self._report

    # -- cut policy ----------------------------------------------------------

    def _on_apply(self, replica: ReadReplica, rec_type: int,
                  state: dict) -> None:
        # called under the replica's apply lock: keep it O(1) except at
        # cut points, where the O(shard) copy is the point
        from distkeras_tpu_torch.resilience import wal as _wal

        v = int(state["num_updates"])
        if rec_type == _wal.REC_EPOCH:
            epoch = state.get("epoch_mark")
            if v > 0:
                self._capture(replica, state, v, epoch)
            return
        if rec_type in (_wal.REC_COMMIT, _wal.REC_COMMIT2,
                        _wal.REC_COMMIT_WIRE, _wal.REC_COMMIT_FLAT):
            if self.snapshot_every and v and v % self.snapshot_every == 0:
                self._capture(replica, state, v, None)

    def _capture(self, replica: ReadReplica, state: dict, version: int,
                 epoch) -> None:
        if "_flat" in state:
            # native flat replay keeps the center as a flat vector until
            # stream end; cutting mid-flat would need a spec unflatten —
            # materialize through the replica's own view instead
            from distkeras_tpu_torch.resilience.wal import _flat_replay_state

            flat = _flat_replay_state(state)
            tree = flat["spec"].unflatten(flat["c"].copy())
        else:
            tree = _tree_copy(state["center"])
        self._q.put((replica.shard_id, version, epoch, tree))

    # -- assembly / publish --------------------------------------------------

    def _publish_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            sid, version, epoch, tree = item
            ready = None
            with self._mu:
                slot = self._pending.setdefault(version, {})
                slot[sid] = (tree, epoch)
                if len(slot) == len(self.replicas):
                    ready = self._pending.pop(version)
                    # an older cut can never complete once a newer one
                    # has: every shard passes each version exactly once
                    for stale in [x for x in self._pending if x < version]:
                        del self._pending[stale]
            if ready is None:
                continue
            if self.plan is None:
                tree, epoch = ready[0]
            else:
                parts = [ready[sid][0] for sid in range(len(self.replicas))]
                tree = self.plan.join(parts)
                epochs = {e for _, e in ready.values() if e is not None}
                epoch = min(epochs) if epochs else None
            if self.store.publish(version, tree, epoch=epoch):
                _trace.instant("deploy.snapshot", cat="deploy",
                               args={"version": version,
                                     "epoch": -1 if epoch is None else epoch})
                if self._report is not None:
                    try:
                        self._report(version)
                    except Exception:
                        pass  # a dead trainer must not kill publishing

    # -- reads / teardown ----------------------------------------------------

    def stats(self) -> dict:
        latest = self.store.latest()
        return {
            "replicas": [r.stats() for r in self.replicas],
            "published": self.store.published,
            "latest_version": 0 if latest is None else latest.version,
            "checkpoints_written": self.store.checkpoints_written,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            rep.stop()
        self._q.put(None)
        self._publisher.join(timeout=5.0)
