"""Asynchronous parameter servers: the center variable, its fold queue and
the socket service.

Port of ``distkeras_tpu/parameter_servers.py`` (``ParameterServer``,
``SocketParameterServer``, ``ParameterServerClient``, ``build_ps_stats``)
for ``backend="ps"``: hogwild worker threads pull the center, train a
window on the card, and commit; the server folds commits one at a time
with the rule's ``MergeRule.fold``, exactly as the reference does.

**The center lives in host memory, as numpy, by design.** The reference's
parameter server is a host process that folds numpy trees; only the
workers' compute belongs on the card. The port keeps that split: the
center is no CPU stand-in for device work, and no tensor reaches it.

Staleness is tracked for real: ``pull`` records the center version a
worker saw; ``commit`` computes τ = center updates since that pull and
hands it to the rule (DynSGD scales by 1/(τ+1); the other rules ignore
it). ``recent_staleness()`` keeps the last 512 τ. Every recorded pull also
keeps the version before it: a pipelined worker's exchange carries
``lag=True`` and is priced from that previous version, because the delta
it commits was computed from the center of one exchange earlier.

Locking discipline, as in the reference:

- ``_lock`` (the center lock, timed for ``stats()``) protects ``center``,
  ``num_updates`` and the pull versions. Its sections are O(fold): each
  fold rebinds ``center`` to a fresh tree, so a published center is an
  immutable snapshot; pulls only record the version and take the
  snapshot's reference.
- commits queue in ``_fold_pending`` and the thread that wins the center
  lock folds every queued commit in arrival order (flat combining): K
  colocated workers' windows fold under fewer than K acquisitions, with
  the same results as one acquisition each.
- each worker's compressed-pull residual has its own lock, so int8 pull
  encodes of different workers overlap.

The resilience layer (``resilience/``) lives here too, as in the
reference:

- **exactly-once commits**: a commit may carry a per-worker ``seq``
  (assigned by ``ResilientPSClient``); a (worker, seq) already applied is
  counted in ``dup_commits`` and not folded, so a lost-ACK replay never
  folds twice;
- **fencing**: a commit carrying an ``epoch`` folds only when it equals
  ``fence_epoch``; otherwise it raises ``FencedEpochError`` and counts in
  ``fenced_commits``. ``fence(epoch)`` raises the epoch (the promoting
  supervisor's last word to a superseded primary);
- **leases**: ``heartbeat`` renews a worker's lease in a
  ``WorkerRegistry`` (and each of its pulls and commits extends a lease it
  holds); a lapsed lease evicts the worker, which forgets its pull
  versions (its zombie commit is priced τ = num_updates by DynSGD) and its
  dedup entry;
- **durability**: with ``wal_dir`` every state change is appended to the
  write-ahead log (``resilience/wal.py``) inside the center lock, before
  the ACK; in group mode (``wal_group_window`` > 1) a commit's ACK waits
  for its group's fsync. Snapshots truncate the log; a server built on a
  directory that holds a log recovers it, bit for bit;
- **the hot standby and chain replication**: ``attach_standby`` streams
  the same records to a :class:`StandbySocketParameterServer`, which
  applies them through ``wal.replay_record``, forwards each applied record
  to its own successor when it has one (a chain, ``sharding/``), and
  serves once ``promote``d;
- **the shard map**: a server holding one shard of a sharded center
  (``sharding/``) carries its plan's record in ``shard_info`` and answers
  the ``shard_map`` action with it (None when unsharded), so a client
  wired to the wrong shard fails fast.

**The center's EMA** (``ema_decay``): after each applied commit the
server folds ``e = d·e + (1−d)·c`` with the post-fold center, under its
own ``_ema_lock`` (never the center lock) into preallocated scratch, in
version order: a fold that lost the race to a newer center is dropped.
``get_ema()`` reads it. WAL snapshots carry it (``ema``, ``ema_version``),
replay refolds it, and a standby receives it with its replication base,
so a recovered or promoted server's EMA is the live one's, bit for bit.

**Elastic membership** (``resilience/elastic.py``): ``join_worker``
leases a live joiner (quietly: ``heartbeats`` stays a heartbeat count) and
grows the ``pool_size`` gauge; ``drain_worker`` is a clean deregister plus
the ``preempted_workers`` and ``drain_timeouts`` counters. Both ride lossy
links, so each counts once per membership flip of a worker id (a lost-ACK
replay counts nothing); an eviction retires a worker's records. The
``join`` and ``drain`` wire actions serve them.

Deploy streaming and the metrics registry belong to a later slice
(``ROADMAP.md`` A13): their wire actions answer with an error frame naming
the item, and the deploy counters stay 0.
"""

from __future__ import annotations

import collections
import contextlib
import pickle
import socket
import threading
import time
import zlib
from typing import Any

import numpy as np

from distkeras_tpu_torch import networking, utils
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.parallel.compression import (
    _LEAF,
    _MARK,
    is_encoded,
    maybe_decode,
    validate_pull_compression,
)
from distkeras_tpu_torch.parallel.merge_rules import MergeRule
from distkeras_tpu_torch.resilience import wal as _wal
from distkeras_tpu_torch.resilience.heartbeat import WorkerRegistry

Tree = Any

#: wire actions of later slices → the ROADMAP item that ports them
_LATER_ACTIONS = {
    "deploy_report": "A13 (deploy streaming)",
    "metrics": "A13 (observability: metrics)",
}

#: follower wake/retry slice of the batched fold drain (seconds)
_FOLD_WAIT_SLICE = 0.0005


class _TimedLock:
    """``threading.Lock`` with wait/hold accounting (monotonic ns) for
    ``stats()``. Counters change while the lock is held; reads are
    approximate."""

    __slots__ = ("_lock", "acquires", "wait_ns", "hold_ns", "_t_acq")

    def __init__(self):
        self._lock = threading.Lock()
        self.acquires = 0
        self.wait_ns = 0
        self.hold_ns = 0
        self._t_acq = 0

    def acquire(self, blocking: bool = True) -> bool:
        """Only a successful acquire counts: a follower whose fold rode the
        leader's acquisition never touches the lock."""
        t0 = time.perf_counter_ns()
        if not self._lock.acquire(blocking):
            return False
        t1 = time.perf_counter_ns()
        self.wait_ns += t1 - t0
        self.acquires += 1
        self._t_acq = t1
        return True

    def release(self) -> None:
        self.hold_ns += time.perf_counter_ns() - self._t_acq
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _FoldWork:
    """One queued commit (or fused exchange) awaiting the fold drain: the
    pre-lock-encoded inputs in, the locked section's outputs back to the
    submitting thread, which runs every post-lock step (the durability
    wait, the chaos hook, the counters) itself."""

    __slots__ = ("worker_id", "payload", "seq", "epoch", "lag", "fused",
                 "compressed", "wire_frame", "rec_payload", "rec_sum",
                 "rec_type", "corr", "done", "exc", "fenced", "server_epoch",
                 "dup", "version", "center_snap", "snap_out", "st",
                 "wait_token", "snap_state", "batched")

    def __init__(self, worker_id, payload, seq, epoch, lag, fused,
                 compressed, wire_frame, rec_payload, rec_sum, rec_type,
                 corr):
        self.worker_id = worker_id
        self.payload = payload
        self.seq = seq
        self.epoch = epoch
        self.lag = lag
        self.fused = fused
        self.compressed = compressed
        self.wire_frame = wire_frame
        self.rec_payload = rec_payload
        self.rec_sum = rec_sum
        self.rec_type = rec_type
        self.corr = corr
        self.done = threading.Event()
        self.exc: BaseException | None = None
        self.fenced = False
        self.server_epoch = 0
        self.dup = False
        self.version = 0
        self.center_snap = None   # the post-fold center, for the EMA
        self.snap_out = None
        self.st = None
        self.wait_token = None
        self.snap_state = None
        self.batched = False


class _PullState:
    """One worker's compressed-pull state: the error-feedback residual and
    encode scratch under the worker's own lock (allocated on its first
    compressed pull, never under the center lock)."""

    __slots__ = ("lock", "err", "qf", "epoch")

    def __init__(self):
        self.lock = threading.Lock()
        self.err: list | None = None   # per-leaf f32 residuals (None = exact)
        self.qf: list | None = None    # per-leaf f32 scratch
        self.epoch = 0                 # encode counter: guards late rollbacks


def _tree_copy(tree: Tree) -> Tree:
    return utils.host_tree_map(np.copy, tree)


def validate_ema_decay(ema_decay):
    """``ema_decay`` as a float in [0, 1), or None (the EMA off)."""
    if ema_decay is None:
        return None
    ema_decay = float(ema_decay)
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    return ema_decay


def _is_floatish(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.floating)


class ParameterServer:
    """In-process center variable with per-algorithm fold semantics; the
    shared PS of same-process worker threads (``ps_transport=
    "inprocess"``) and the base of :class:`SocketParameterServer`."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, snapshot_every: int = 100,
                 fence_epoch: int = 0, wal_group_window: int = 8,
                 wal_group_interval: float = 0.25):
        self.center = utils.tree_to_numpy(center)
        self.rule = rule
        self.num_workers = int(num_workers)
        self.num_updates = 0
        # the fencing epoch: a commit carrying an epoch token folds only
        # when it matches (center lock)
        self.fence_epoch = int(fence_epoch)
        self._n_fenced_commits = 0
        self._lock = _TimedLock()
        self._pull_versions: dict[int, int] = {}
        # the version each worker's pull recorded before its latest one:
        # every record shifts cur → prev (center lock)
        self._prev_pull_versions: dict[int, int] = {}
        self._fold_mu = threading.Lock()
        self._fold_pending: list[_FoldWork] = []
        # leases renewed by heartbeats; a worker that never heartbeats is
        # never leased, so nothing expires on a run without them
        self.lease_timeout = (
            30.0 if lease_timeout is None else float(lease_timeout))
        self._registry = WorkerRegistry(self.lease_timeout,
                                        on_evict=self._on_evict)
        # the commit dedup: each worker's last APPLIED seqno (center lock)
        self._last_seq: dict[int, int] = {}
        # the Polyak average of the center (None: off), folded per commit
        # under its own lock from the post-fold snapshot; _ema_version
        # orders racing folds, and the scratch is reused by every fold
        self.ema_decay = validate_ema_decay(ema_decay)
        self._ema = None if ema_decay is None else _tree_copy(self.center)
        self._ema_lock = threading.Lock()
        self._ema_version = 0
        self._ema_scratch = (None if self._ema is None
                             else utils.host_tree_map(np.empty_like,
                                                      self._ema))
        self._pull_errors: dict[int, _PullState] = {}
        self._stats_lock = threading.Lock()
        self._n_pending_replies = 0
        self._n_pulls = 0
        self._n_compressed_pulls = 0
        self._n_commits = 0
        self._n_dup_commits = 0
        self._n_fused = 0
        self._n_batched_folds = 0
        self._bytes_in = 0
        self._bytes_out = 0
        # elastic membership (stats lock): the pool gauge starts at the
        # configured worker count, joins grow it and drains shrink it;
        # telemetry, not durable state. A worker id's join counts once
        # until it drains and its drain once until it re-joins (a replay
        # after a lost ACK counts nothing); eviction retires both records
        self._pool_size = int(num_workers)
        self._n_joined = 0
        self._n_preempted = 0
        self._n_drain_timeouts = 0
        self._joined_wids: set[int] = set()
        self._drained_wids: set[int] = set()
        self._t_start = time.monotonic()
        self._center_nbytes = sum(
            np.asarray(leaf).nbytes for leaf in utils.flatten(self.center)[0])
        self._tau_recent: collections.deque = collections.deque(maxlen=512)
        # durability: the write-ahead log and the hot-standby stream get
        # the same framed records, inside the center lock (durable order
        # is fold order) and before the ACK; a commit's payload is
        # pickled and checksummed before the lock
        self._wal = None
        self.recovered_ = False
        self.wal_replay_s = 0.0
        if wal_dir is not None:
            t0 = time.monotonic()
            state = _wal.recover_ps_state(wal_dir, rule, self.num_workers,
                                          self.ema_decay,
                                          template=self.center)
            if state is not None:
                self._adopt_state(state)
                self.recovered_ = True
                self.wal_replay_s = time.monotonic() - t0
            self._wal = _wal.CommitLog(wal_dir, snapshot_every=snapshot_every,
                                       group_window=wal_group_window,
                                       group_interval=wal_group_interval)
            self._wal.open_segment(self.num_updates)
        self._replica_sock = None   # the hot-standby stream
        self._n_standby_drops = 0
        # chaos seam: called with the post-fold version after every
        # applied commit, outside the center lock (the kill-PS fault)
        self.post_commit_hook = None
        # the shard-map record ({"shard_id", "num_shards", "ring"}) of a
        # server holding one shard of a sharded center; None unsharded
        self.shard_info: dict | None = None

    def _adopt_state(self, state: dict) -> None:
        """Install a recovered or streamed state (``wal.ps_state_dict``'s
        shape); the caller holds no lock yet or the center lock."""
        self.center = state["center"]
        self.num_updates = int(state["num_updates"])
        self._pull_versions = dict(state["pull_versions"])
        self._prev_pull_versions = dict(state.get("prev_pull_versions", {}))
        self._last_seq = dict(state["last_seq"])
        self.fence_epoch = max(self.fence_epoch, int(state["fence_epoch"]))
        if self.ema_decay is not None and state.get("ema") is not None:
            self._ema = state["ema"]
            self._ema_version = int(state["ema_version"])
            self._ema_scratch = utils.host_tree_map(np.empty_like, self._ema)
        self._center_nbytes = sum(
            np.asarray(leaf).nbytes for leaf in utils.flatten(self.center)[0])

    def _capture_state_locked(self) -> dict:
        """The recoverable state (call under the center lock): O(workers)
        dict copies and a reference to the immutable center. The EMA is
        added after, by :meth:`_attach_ema_state` under its own lock (one
        lock at a time); its version may run ahead of the center's, which
        replay handles by skipping EMA folds at or below ``ema_version``."""
        return _wal.ps_state_dict(
            self.center, self.num_updates, self._pull_versions,
            self._last_seq, None, 0, self.fence_epoch,
            prev_pull_versions=self._prev_pull_versions)

    def _attach_ema_state(self, state: dict) -> dict:
        if self._ema is not None:
            with self._ema_lock:
                state["ema"] = _tree_copy(self._ema)
                state["ema_version"] = self._ema_version
        return state

    def _fold_ema(self, version: int, snap: Tree) -> None:
        """``e = d·e + (1−d)·c`` with the center of ``version``, the
        reference's numpy ops in its order, unless a newer center already
        folded (this one is subsumed)."""
        d = self.ema_decay

        def fma(e, c, s):
            np.multiply(np.asarray(c, dtype=e.dtype), 1.0 - d, out=s)
            e *= d
            e += s

        with self._ema_lock:
            if version > self._ema_version:
                self._ema_version = version
                utils.host_tree_map(fma, self._ema, snap, self._ema_scratch)

    def get_ema(self) -> Tree:
        """The Polyak-averaged center (None unless ``ema_decay`` was set);
        a copy taken under the EMA's lock (it is folded in place)."""
        if self._ema is None:
            return None
        with self._ema_lock:
            return _tree_copy(self._ema)

    @property
    def _durable(self) -> bool:
        return self._wal is not None or self._replica_sock is not None

    # -- service lifecycle (no-ops for the in-process PS) --------------------

    def initialize(self) -> None:
        pass

    def run(self) -> None:
        pass

    def stop(self) -> None:
        self._close_durability()

    def _close_durability(self) -> None:
        """Flush and close the WAL and the replication stream (a clean
        stop; a crash skips this)."""
        if self._wal is not None:
            self._wal.close()
        sock, self._replica_sock = self._replica_sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- pulls ----------------------------------------------------------------

    def pull(self, worker_id: int, compressed: bool = False) -> Tree:
        """The current center (a copy), recording the version this worker
        saw. ``compressed=True`` returns an int8 blob instead (decode with
        ``parallel.compression.maybe_decode``): each float leaf is absmax-
        quantized after adding this worker's residual, and the new residual
        stays here, so the decoded pulls telescope to the true center."""
        snap, st = self._begin_pull(worker_id, compressed)
        if not compressed:
            out = _tree_copy(snap)  # O(model), off the center lock
            self._count(pulls=1, bytes_out=self._center_nbytes)
            return out
        with st.lock:
            blob, nbytes = self._encode_pull(st, snap)
        self._count(compressed_pulls=1, bytes_out=nbytes)
        return blob

    def _begin_pull(self, worker_id: int, compressed: bool) -> tuple:
        """The one O(1) center-lock pull preamble of every transport: record
        the version (and log it: pull versions are recoverable state), take
        the immutable snapshot, resolve the residual."""
        self._registry.touch(worker_id)
        with self._lock:
            self._record_pull_locked(worker_id)
            snap = self.center
            st = None
            if compressed:
                st = self._pull_errors.get(worker_id)
                if st is None:
                    st = self._pull_errors[worker_id] = _PullState()
        return snap, st

    def _record_pull_locked(self, worker_id: int) -> None:
        """Record a pull at the current ``num_updates`` (call under the
        center lock), keeping the version it replaces as the previous."""
        if worker_id in self._pull_versions:
            self._prev_pull_versions[worker_id] = \
                self._pull_versions[worker_id]
        self._pull_versions[worker_id] = self.num_updates
        if self._durable:
            self._log_locked(_wal.encode_record(
                _wal.REC_PULL, (int(worker_id), int(self.num_updates))))

    def _encode_pull(self, st: _PullState, snapshot: Tree) -> tuple:
        """Quantize ``snapshot + residual`` to int8 and update the residual,
        in per-worker scratch (call under ``st.lock``): add → absmax →
        divide → rint → dequantize-subtract in f32, the reference's
        sequence, so the blobs are the reference's bit for bit."""
        leaves, structure = utils.flatten(snapshot)
        if st.err is None:
            st.err = [np.zeros(np.shape(leaf), np.float32)
                      if _is_floatish(np.asarray(leaf)) else None
                      for leaf in leaves]
            st.qf = [None if e is None else np.empty_like(e) for e in st.err]
        enc = []
        nbytes = 0
        for i, leaf in enumerate(leaves):
            arr = np.asarray(leaf)
            err = st.err[i]
            if err is None:
                out = np.copy(arr)  # integer/bool leaves: exact
                enc.append(out)
                nbytes += out.nbytes
                continue
            dt = arr.dtype.name
            if arr.dtype != np.float32:
                arr = arr.astype(np.float32)
            qf = st.qf[i]
            # err holds v = center + residual after the add, and the new
            # residual after the final subtract
            np.add(arr, err, out=err)
            amax = (max(float(err.max()), -float(err.min()))
                    if err.size else 0.0)
            scale = amax / 127.0 if amax > 0 else 1.0
            if np.float32(scale) >= np.finfo(np.float32).tiny:
                # a normal f32 scale keeps |v/scale| < 127.5: rint lands in
                # [-127, 127] with no clip
                np.divide(err, np.float32(scale), out=qf)
                np.rint(qf, out=qf)
                q = qf.astype(np.int8)
                np.multiply(qf, np.float32(scale), out=qf)
                np.subtract(err, qf, out=err)
            else:
                # degenerate leaf (the scale underflows): clipped encode,
                # the whole magnitude stays in the residual
                with np.errstate(divide="ignore", invalid="ignore",
                                 over="ignore"):
                    qi = np.clip(np.rint(err / np.float32(scale)), -127, 127)
                    np.nan_to_num(qi, copy=False, nan=0.0, posinf=127.0,
                                  neginf=-127.0)
                    q = qi.astype(np.int8)
                    np.subtract(err, q.astype(np.float32) * np.float32(scale),
                                out=err)
            enc.append({_LEAF: "int8", "dt": dt, "q": q, "s": scale})
            nbytes += q.nbytes + 8  # payload + per-leaf scale
        st.epoch += 1  # this encode supersedes any pending late rollback
        return {_MARK: "int8", "tree": utils.unflatten(structure, enc)}, nbytes

    def _rollback_encode_locked(self, st: _PullState, snapshot: Tree,
                                blob: dict) -> None:
        """Undo one ``_encode_pull``'s residual advance for a reply that
        was never delivered (call under ``st.lock`` with the snapshot the
        encode saw): ``err_old = v − c`` from ``err = v − s·q``."""
        enc_leaves = utils.flatten(_encoded_as_leaves(blob["tree"]))[0]
        for i, (enc, c) in enumerate(zip(enc_leaves,
                                         utils.flatten(snapshot)[0])):
            err = st.err[i]
            if err is None:
                continue
            dq = np.multiply(enc.leaf["q"], np.float32(enc.leaf["s"]),
                             dtype=np.float32)
            np.add(err, dq, out=err)
            np.subtract(err, np.asarray(c, np.float32), out=err)

    # -- commits --------------------------------------------------------------

    def commit(self, worker_id: int, payload: Tree, seq: int | None = None,
               epoch: int | None = None,
               wire_frame: bytes | None = None) -> bool:
        """Fold one worker's commit into the center (decoded first when it
        arrives codec-compressed). ``seq`` makes the fold exactly-once: a
        (worker, seq) already applied is counted as a duplicate and not
        folded. ``epoch`` is the client's fencing token: a mismatch raises
        ``FencedEpochError`` without folding (None is never fenced).
        ``wire_frame`` is the request's raw frame, logged verbatim by a
        durable server. Returns True when the commit folded, False for a
        duplicate."""
        applied, _snap, _st = self._commit_impl(
            worker_id, payload, seq=seq, epoch=epoch, wire_frame=wire_frame)
        return applied

    def exchange(self, worker_id: int, payload: Tree, seq: int | None = None,
                 epoch: int | None = None, lag: bool = False,
                 compressed: bool = False,
                 wire_frame: bytes | None = None) -> tuple:
        """Fused commit + pull under one center-lock section: the fold is
        priced as a commit would be, then the pull version is recorded at
        the post-fold ``num_updates``. ``lag=True`` (the pipelined worker)
        prices τ from the previous recorded pull version instead. A
        duplicate skips the fold but still gets the pull half (a lost-ACK
        replay needs the fresh center); a fenced exchange raises. Returns
        ``(center copy or int8 blob, applied)``."""
        applied, snap, st = self._commit_impl(
            worker_id, payload, seq=seq, epoch=epoch, lag=lag, fused=True,
            compressed=compressed, wire_frame=wire_frame)
        if not compressed:
            out = _tree_copy(snap)  # O(model), off the center lock
            self._count(pulls=1, bytes_out=self._center_nbytes, fused=1)
            return out, applied
        with st.lock:
            blob, nbytes = self._encode_pull(st, snap)
        self._count(compressed_pulls=1, bytes_out=nbytes, fused=1)
        return blob, applied

    def _commit_impl(self, worker_id: int, payload: Tree,
                     seq: int | None = None, epoch: int | None = None,
                     wire_frame: bytes | None = None, lag: bool = False,
                     fused: bool = False, compressed: bool = False) -> tuple:
        """Decode and (durable servers) encode the WAL record off the lock,
        fold through the batched drain, then the chaos hook and the
        deferred-ACK durability wait. Counts the commit side. Returns
        ``(applied, snap, st)``: the fused pull's snapshot and residual
        state (None unless ``fused``)."""
        # a request from a leased worker extends its lease before the fold:
        # an eviction between this fold and a replay of its lost ACK would
        # retire the dedup entry and fold the replay twice
        self._registry.touch(worker_id)
        nbytes = self._payload_nbytes(payload)  # wire size: BEFORE decode
        with _trace.span("ps.decode"):
            payload = maybe_decode(payload)
        rec_payload, rec_sum, rec_type = None, 0, _wal.REC_COMMIT2
        if self._durable:
            # the log replays the EXACT fold input: the request frame as it
            # crossed the wire when there is one, else the pickled tree;
            # both pickle and checksum here, in this worker's thread
            payload = utils.tree_to_numpy(payload)
            rec_payload, rec_type = self._record_payload(payload,
                                                         wire_frame)
            rec_sum = zlib.adler32(rec_payload)
        work = _FoldWork(worker_id, payload, seq, epoch, lag, fused,
                         compressed, wire_frame, rec_payload, rec_sum,
                         rec_type,
                         _trace.current_corr() if _trace.enabled() else None)
        self._enqueue_and_fold(work)
        if work.exc is not None:
            raise work.exc
        if work.fenced:
            # the payload crossed the wire: its bytes count, not a commit
            self._count(bytes_in=nbytes)
            raise networking.FencedEpochError(
                "commit fenced: a newer primary holds this history",
                client_epoch=epoch, server_epoch=work.server_epoch)
        if work.dup:
            self._count(dup_commits=1, bytes_in=nbytes)
            return False, work.snap_out, work.st
        self._count(commits=1, bytes_in=nbytes,
                    batched_folds=1 if work.batched else 0)
        hook = self.post_commit_hook
        if hook is not None:
            # the kill-PS seam, BEFORE the durability wait: a crash here
            # leaves this commit appended but its group unflushed, the
            # torn-group case whose replay must fold exactly once
            hook(work.version)
        if self._wal is not None:
            if work.wait_token is not None and self._wal.group_mode:
                # group commit: the ACK this return releases implies
                # fsync'd. A failed wait (the log was abandoned by a crash
                # or an I/O error, or timed out) refuses the ACK: the
                # client replays, and the dedup table of whichever server
                # answers next folds it at most once
                with _trace.span("ps.wal_wait"):
                    durable = self._wal.wait_durable(work.wait_token)
                if not durable:
                    raise networking.ProtocolError(
                        "commit folded but its WAL group never became "
                        "durable (log abandoned or fsync stalled): no ACK; "
                        "replay it", retryable=True)
            else:
                self._wal.maybe_fsync()  # periodic, off the critical path
        if self._ema is not None:
            self._fold_ema(work.version, work.center_snap)
        if work.snap_state is not None and self._wal._fh is not None:
            self._attach_ema_state(work.snap_state)
            self._wal.publish_snapshot(work.snap_state)
        return True, work.snap_out, work.st

    @staticmethod
    def _record_payload(payload: Tree, wire_frame: bytes | None) -> tuple:
        """``(bytes, record type)`` of one commit's log record."""
        if wire_frame is not None:
            return wire_frame, _wal.REC_COMMIT_WIRE
        return (pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL),
                _wal.REC_COMMIT2)

    def _enqueue_and_fold(self, work: _FoldWork) -> None:
        """Enqueue, then either lead (take the center lock once and fold
        every queued commit in arrival order) or wait for the current
        leader to fold ours."""
        t0 = time.perf_counter_ns()
        with self._fold_mu:
            self._fold_pending.append(work)
        while True:
            if self._lock.acquire(blocking=False):
                try:
                    with self._fold_mu:
                        batch = self._fold_pending
                        self._fold_pending = []
                    if batch:
                        self._drain_folds_locked(batch)
                finally:
                    self._lock.release()
                # any drain since our enqueue included our work
                return
            if work.done.wait(timeout=_FOLD_WAIT_SLICE):
                # a follower never acquires: credit its time-to-fold to the
                # lock's wait (approximate, unsynchronized)
                self._lock.wait_ns += time.perf_counter_ns() - t0
                return

    def _drain_folds_locked(self, batch: list[_FoldWork]) -> None:
        if len(batch) >= 2:
            with _trace.span("ps.fold_batch", args={"k": len(batch)}):
                for work in batch:
                    work.batched = True
                    self._fold_one_locked(work)
            return
        for work in batch:
            self._fold_one_locked(work)

    def _fold_one_locked(self, work: _FoldWork) -> None:
        """One commit's center-lock section: fence check, seqno dedup, the
        fold, its log record and a due snapshot's rotation, then the fused
        pull half; always sets ``work.done``."""
        t0 = time.perf_counter_ns()
        worker_id = work.worker_id
        try:
            fenced = (work.epoch is not None
                      and work.epoch != self.fence_epoch)
            work.server_epoch = self.fence_epoch
            dup = False
            if not fenced and work.seq is not None:
                if work.seq <= self._last_seq.get(worker_id, 0):
                    dup = True
                else:
                    self._last_seq[worker_id] = work.seq
            if not fenced and not dup:
                if work.lag and worker_id in self._prev_pull_versions:
                    # the pipelined delta was computed from the center of
                    # one exchange ago: price τ from the previous pull
                    pull_version = self._prev_pull_versions[worker_id]
                else:
                    pull_version = self._pull_versions.get(worker_id, 0)
                staleness = self.num_updates - pull_version
                self._tau_recent.append(int(staleness))
                self.center = utils.tree_to_numpy(self.rule.fold(
                    self.center, work.payload, self.num_workers, staleness))
                self.num_updates += 1
                work.version = self.num_updates
                work.center_snap = self.center
                if work.rec_payload is None and self._durable:
                    # a standby attached between the pre-lock check and
                    # this fold: encode here, so the stream misses nothing
                    work.payload = utils.tree_to_numpy(work.payload)
                    work.rec_payload, work.rec_type = self._record_payload(
                        work.payload, work.wire_frame)
                    work.rec_sum = zlib.adler32(work.rec_payload)
                if work.rec_payload is not None:
                    work.wait_token = self._log_commit_locked(
                        work, pull_version)
                if self._wal is not None and self._wal.should_snapshot():
                    # phase 1 under the lock: rotate the segment at this
                    # version and capture the state; the O(model) publish
                    # runs after the lock in the submitting thread
                    self._wal.rotate(self.num_updates)
                    work.snap_state = self._capture_state_locked()
            if work.fused and not fenced:
                # the fused pull half, for applied and duplicate commits
                self._record_pull_locked(worker_id)
                work.snap_out = self.center
                if work.compressed:
                    st = self._pull_errors.get(worker_id)
                    if st is None:
                        st = self._pull_errors[worker_id] = _PullState()
                    work.st = st
            if fenced:
                self._n_fenced_commits += 1
            work.fenced = fenced
            work.dup = dup
        except BaseException as e:  # carried to the submitting thread
            work.exc = e
        finally:
            if _trace.enabled():
                _trace.record("ps.fold", t0, time.perf_counter_ns(),
                              corr=work.corr)
            work.done.set()

    def _log_commit_locked(self, work: _FoldWork,
                           pull_version: int) -> int | None:
        """Hand one commit record to every durable sink (center lock):
        frames the pre-encoded payload, never copying or hashing it.
        Returns the WAL durability token (None without a WAL)."""
        with _trace.span("ps.wal_append", corr=work.corr):
            chunks = _wal.encode_commit_chunks(
                work.worker_id, work.seq, pull_version, work.version,
                work.rec_payload, work.rec_sum, rec_type=work.rec_type)
            token = None
            if self._wal is not None:
                token = self._wal.append_chunks(chunks)
                self._wal.commits_since_snapshot += 1
            self._send_replica_locked(chunks)
        return token

    def _log_locked(self, rec: bytes) -> None:
        """Hand one framed non-commit record to every durable sink (center
        lock, so durable order is fold order)."""
        if self._wal is not None:
            self._wal.append(rec)
        self._send_replica_locked((rec,))

    def _send_replica_locked(self, chunks) -> None:
        """Stream a record to the standby; a send failure drops the
        replica (counted) instead of wedging the fold path."""
        sock = self._replica_sock
        if sock is None:
            return
        try:
            for chunk in chunks:
                sock.sendall(chunk)
        except OSError:
            self._replica_sock = None
            self._n_standby_drops += 1
            try:
                sock.close()
            except OSError:
                pass

    def get_model(self) -> Tree:
        with self._lock:
            snap = self.center
        return _tree_copy(snap)  # the snapshot is immutable: copy off-lock

    # -- liveness, fencing, replication ----------------------------------------

    def heartbeat(self, worker_id: int, retries: int = 0) -> bool:
        """Renew (auto-registering) ``worker_id``'s lease; ``retries`` is
        the client's cumulative retry count, surfaced in ``stats()``.
        False when this heartbeat (re-)registered the worker."""
        return self._registry.renew(worker_id, retries=retries)

    def deregister_worker(self, worker_id: int) -> None:
        """A clean exit: drop the lease without counting an eviction, and
        retire the worker's dedup entry and pull versions (a same-id
        successor starts fresh)."""
        self._registry.deregister(worker_id)
        with self._lock:
            self._last_seq.pop(worker_id, None)
            self._pull_versions.pop(worker_id, None)
            self._prev_pull_versions.pop(worker_id, None)
            if self._durable:
                self._log_locked(_wal.encode_record(_wal.REC_DEREG,
                                                    (int(worker_id),)))

    def join_worker(self, worker_id: int) -> dict:
        """Live-join admission: lease the worker (quietly: ``heartbeats``
        stays a heartbeat count) and grow the pool gauge. The joiner's
        next pull records its pull version, so its first DynSGD commit is
        priced at the true small τ. Returns the admission record the wire
        action answers with: ``{"pool_size", "num_updates"}``."""
        _trace.instant("ps.join", corr=f"w{worker_id}")
        self._registry.register(worker_id)
        with self._stats_lock:
            self._drained_wids.discard(worker_id)
            if worker_id not in self._joined_wids:
                self._joined_wids.add(worker_id)
                self._n_joined += 1
                self._pool_size += 1
            pool = self._pool_size
        with self._lock:
            updates = self.num_updates
        return {"pool_size": pool, "num_updates": updates}

    def drain_worker(self, worker_id: int, timeout: bool = False) -> None:
        """Preemption drain: a clean deregister (the lease dropped without
        an eviction, the dedup seqno retired) plus the membership counters;
        ``timeout=True`` records a drain whose deadline lapsed (the
        coordinator's force-drain; eviction stays the backstop)."""
        _trace.instant("ps.drain", corr=f"w{worker_id}",
                       args={"timeout": bool(timeout)})
        self.deregister_worker(worker_id)
        with self._stats_lock:
            if worker_id in self._drained_wids:
                return
            self._drained_wids.add(worker_id)
            self._joined_wids.discard(worker_id)
            self._n_preempted += 1
            if timeout:
                self._n_drain_timeouts += 1
            self._pool_size = max(0, self._pool_size - 1)

    def _on_evict(self, worker_ids: list[int]) -> None:
        """A lapsed lease: forget the workers' pull versions (DynSGD prices
        a zombie commit at τ = num_updates), their dedup entries and their
        join and drain records (a returning worker re-registers, and the
        sets stay bounded under long churn)."""
        with self._lock:
            for wid in worker_ids:
                self._pull_versions.pop(wid, None)
                self._prev_pull_versions.pop(wid, None)
                self._last_seq.pop(wid, None)
            if self._durable:
                self._log_locked(_wal.encode_record(
                    _wal.REC_EVICT, ([int(w) for w in worker_ids],)))
        with self._stats_lock:
            for wid in worker_ids:
                self._joined_wids.discard(wid)
                self._drained_wids.discard(wid)

    def fence(self, epoch: int) -> int:
        """Raise the fencing epoch (monotone): commits carrying an older
        token are refused from here on. Durable before it returns when a
        WAL is attached."""
        with self._lock:
            self.fence_epoch = max(self.fence_epoch, int(epoch))
            out = self.fence_epoch
            if self._durable:
                self._log_locked(_wal.encode_record(_wal.REC_FENCE, (out,)))
        if self._wal is not None:
            self._wal.sync()  # the fence's ack implies durability
        return out

    def mark_epoch(self, epoch: int) -> None:
        """Log a training-epoch boundary (``REC_EPOCH``) into the WAL and
        the replication stream, ordered against the folds."""
        with self._lock:
            if self._durable:
                self._log_locked(_wal.encode_record(_wal.REC_EPOCH,
                                                    (int(epoch),)))

    def attach_standby(self, host: str, port: int,
                       timeout: float = 10.0) -> None:
        """Open the hot-standby replication stream: send the replica the
        full state, then every later record (commit, pull, dereg, evict,
        fence) before the corresponding ACK goes out. Call before serving
        traffic."""
        sock = networking.connect(host, int(port), timeout=timeout)
        sock.settimeout(timeout)
        with self._replication_base() as state:
            networking.send_data(sock, {"action": "replicate_stream",
                                        "state": state})
            reply = networking.recv_data(sock)
            if not reply.get("ok"):
                sock.close()
                raise ConnectionError(
                    f"standby at {host}:{port} refused the replication "
                    f"stream: {reply}")
            self._replica_sock = sock
        # a wedged standby costs at most one bounded stall before it is
        # dropped
        sock.settimeout(5.0)

    @contextlib.contextmanager
    def _replication_base(self):
        """The state a new replica starts from, with the lock that orders
        it before every later record held over the handshake. The EMA is
        taken first, under its own lock: attached before traffic, as every
        caller does, it is the center's."""
        ema = self._attach_ema_state({})
        with self._lock:
            state = self._capture_state_locked()
            state["ema"] = ema.get("ema")
            state["ema_version"] = ema.get("ema_version", 0)
            yield state

    @property
    def has_standby(self) -> bool:
        return self._replica_sock is not None

    # -- observability --------------------------------------------------------

    def _payload_nbytes(self, payload: Tree) -> int:
        """Wire size of one commit: the encoded arrays (plus ~8 bytes per
        scalar field) of a codec blob, else the center's size."""
        if not is_encoded(payload):
            return self._center_nbytes
        return sum(leaf.nbytes if isinstance(leaf, np.ndarray) else 8
                   for leaf in utils.flatten(payload)[0])

    def _begin_reply(self) -> None:
        with self._stats_lock:
            self._n_pending_replies += 1

    def _end_reply(self) -> None:
        with self._stats_lock:
            self._n_pending_replies -= 1

    def _settle_stats(self, timeout: float = 1.0) -> bool:
        """Wait (bounded) until no handler sits between sending a reply and
        counting it, so a read after the last reply sees it counted."""
        if self._n_pending_replies == 0:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stats_lock:
                if self._n_pending_replies == 0:
                    return True
            time.sleep(0.001)
        return False

    def _count(self, pulls=0, compressed_pulls=0, commits=0, bytes_in=0,
               bytes_out=0, fused=0, batched_folds=0, dup_commits=0):
        with self._stats_lock:
            self._n_pulls += pulls
            self._n_compressed_pulls += compressed_pulls
            self._n_commits += commits
            self._n_dup_commits += dup_commits
            self._bytes_in += bytes_in
            self._bytes_out += bytes_out
            self._n_fused += fused
            self._n_batched_folds += batched_folds

    def recent_staleness(self) -> list[int]:
        """The recent per-commit τ (newest last, at most 512); a read racing
        the fold's appends retries, then settles for empty."""
        for _ in range(4):
            try:
                return list(self._tau_recent)
            except RuntimeError:
                continue
        return []

    def stats(self, settle: bool = True) -> dict:
        """Contention and throughput counters (``build_ps_stats``'s keys):
        the commit dedup's ``dup_commits``, ``fenced_commits``, the lease
        registry's ``active_workers`` / ``evicted_workers`` /
        ``heartbeats`` / ``worker_retries``, the WAL's records, fsyncs and
        largest group, and the membership's ``pool_size`` (the configured
        workers plus joins minus drains), ``joined_workers``,
        ``preempted_workers`` and ``drain_timeouts``; the deploy counters
        stay 0 until their slice."""
        if settle:
            self._settle_stats()
        elapsed = time.monotonic() - self._t_start
        with self._stats_lock:
            counts = (self._n_pulls, self._n_compressed_pulls,
                      self._n_commits, self._bytes_in, self._bytes_out)
            fusedx, batched = self._n_fused, self._n_batched_folds
            dups = self._n_dup_commits
            pool, joined = self._pool_size, self._n_joined
            preempted, drain_to = self._n_preempted, self._n_drain_timeouts
        hb = self._registry.stats()
        wal = self._wal
        return build_ps_stats(
            *counts, self._lock.acquires, self._lock.wait_ns,
            self._lock.hold_ns, elapsed, dup_commits=dups,
            active_workers=hb["active_workers"],
            evicted_workers=hb["evicted_workers"],
            heartbeats=hb["heartbeats"],
            worker_retries=hb["worker_retries"],
            fenced_commits=self._n_fenced_commits,
            num_updates=self.num_updates,
            wal_records=0 if wal is None else wal.wal_records,
            wal_fsyncs=0 if wal is None else wal.wal_fsyncs,
            wal_group_max=0 if wal is None else wal.wal_group_max,
            pool_size=pool, joined_workers=joined,
            preempted_workers=preempted, drain_timeouts=drain_to,
            fused_exchanges=fusedx,
            batched_folds=batched)


class _EncodedLeaf:
    """A codec leaf dict held as one leaf of the host tree walk."""

    __slots__ = ("leaf",)

    def __init__(self, leaf):
        self.leaf = leaf


def _encoded_as_leaves(tree):
    """The encoded tree with each codec leaf dict wrapped, so
    :func:`utils.flatten` stops at it."""
    if isinstance(tree, dict):
        if _LEAF in tree:
            return _EncodedLeaf(tree)
        return {k: _encoded_as_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encoded_as_leaves(v) for v in tree)
    return tree


def build_ps_stats(pulls: int, compressed_pulls: int, commits: int,
                   bytes_in: int, bytes_out: int, lock_acquires: int,
                   lock_wait_ns: int, lock_hold_ns: int,
                   elapsed_s: float, dup_commits: int = 0,
                   active_workers: int = 0, evicted_workers: int = 0,
                   heartbeats: int = 0, worker_retries: int = 0,
                   fenced_commits: int = 0, num_updates: int = 0,
                   wal_records: int = 0, wal_fsyncs: int = 0,
                   wal_group_max: int = 0, pool_size: int = 0,
                   joined_workers: int = 0, preempted_workers: int = 0,
                   drain_timeouts: int = 0, fused_exchanges: int = 0,
                   batched_folds: int = 0, deploy_version: int = 0) -> dict:
    """The stats dict every PS transport reports: the reference's key set
    and derived values (``exchange_rtts`` counts wire round trips: a fused
    exchange is one commit and one pull in one trip)."""
    elapsed_s = max(elapsed_s, 1e-9)
    return {
        "pulls": pulls,
        "compressed_pulls": compressed_pulls,
        "commits": commits,
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
        "center_lock_acquires": lock_acquires,
        "center_lock_wait_ns": lock_wait_ns,
        "center_lock_hold_ns": lock_hold_ns,
        "center_lock_mean_hold_ns": (
            lock_hold_ns // lock_acquires if lock_acquires else 0),
        "elapsed_s": elapsed_s,
        "pulls_per_sec": (pulls + compressed_pulls) / elapsed_s,
        "commits_per_sec": commits / elapsed_s,
        "dup_commits": dup_commits,
        "active_workers": active_workers,
        "evicted_workers": evicted_workers,
        "heartbeats": heartbeats,
        "worker_retries": worker_retries,
        "fenced_commits": fenced_commits,
        "num_updates": num_updates,
        "wal_records": wal_records,
        "wal_fsyncs": wal_fsyncs,
        "wal_group_max": wal_group_max,
        "pool_size": pool_size,
        "joined_workers": joined_workers,
        "preempted_workers": preempted_workers,
        "drain_timeouts": drain_timeouts,
        "fused_exchanges": fused_exchanges,
        "exchange_rtts": (pulls + compressed_pulls + commits + dup_commits
                          - fused_exchanges),
        "batched_folds": batched_folds,
        "deploy_version": deploy_version,
        "deploy_lag_folds": (
            max(0, num_updates - deploy_version) if deploy_version else 0),
    }


class SocketParameterServer(ParameterServer):
    """TCP service around the center: one handler thread per connection,
    length-prefixed restricted-pickle frames (``networking.py``). Requests
    are ``{"action": ..., "worker_id": i, "payload": tree?}``; the wire
    actions are ``pull``, ``pull_int8``, ``commit``, ``exchange``,
    ``ping``, ``shard_map``, ``stats``, ``fence``, ``mark_epoch``,
    ``heartbeat``, ``deregister``, ``replicate_stream`` (a standby's) and
    ``stop``/``bye``. A commit or exchange may carry ``seq`` and
    ``epoch``; a fenced one is answered ``{"error": "fenced", "epoch"}``."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 host: str = "127.0.0.1", port: int = 0,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, snapshot_every: int = 100,
                 fence_epoch: int = 0, wal_group_window: int = 8,
                 wal_group_interval: float = 0.25):
        super().__init__(center, rule, num_workers, ema_decay=ema_decay,
                         lease_timeout=lease_timeout, wal_dir=wal_dir,
                         snapshot_every=snapshot_every,
                         fence_epoch=fence_epoch,
                         wal_group_window=wal_group_window,
                         wal_group_interval=wal_group_interval)
        self.host = host
        self.port = int(port)
        self._server_sock: socket.socket | None = None
        self._service_thread: threading.Thread | None = None
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self._running = False
        self.crashed_ = False

    def initialize(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        self.port = sock.getsockname()[1]  # an ephemeral port resolved
        sock.listen(64)
        self._server_sock = sock
        self._running = True

    def start(self) -> None:
        """Run the accept loop in a daemon thread."""
        self._service_thread = threading.Thread(target=self.run, daemon=True)
        self._service_thread.start()

    def run(self) -> None:
        while self._running:
            try:
                conn, _ = self._server_sock.accept()
            except OSError:
                break
            if not self._running:
                conn.close()
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn) -> None:
        try:
            while True:
                # the raw frame too: a durable commit logs it verbatim
                msg, raw = networking.recv_data_raw(conn)
                if self._dispatch(conn, msg, raw):
                    break
        except (ConnectionError, EOFError, OSError, pickle.UnpicklingError):
            # a peer gone, or a hostile frame the restricted unpickler
            # refused: drop the connection quietly
            pass
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    def _dispatch(self, conn, msg: dict, raw: bytes | None) -> bool:
        """Serve one request; True when the connection is done."""
        action = msg.get("action")
        if _trace.enabled():
            _trace.set_corr(msg.get("corr"))
        if action == "pull":
            self._serve_pull(conn, msg["worker_id"])
        elif action == "pull_int8":
            self._serve_compressed_pull(conn, msg["worker_id"])
        elif action == "commit":
            try:
                applied = self.commit(msg["worker_id"], msg["payload"],
                                      seq=msg.get("seq"),
                                      epoch=msg.get("epoch"),
                                      wire_frame=raw)
            except networking.FencedEpochError as fe:
                # a protocol verdict, not a dead connection: answer with
                # the server's epoch so the client raises a typed error
                networking.send_data(conn, {"error": "fenced",
                                            "epoch": fe.server_epoch})
                return False
            networking.send_data(conn, {"ok": True, "dup": not applied})
        elif action == "exchange":
            self._serve_exchange(conn, msg, raw)
        elif action == "ping":
            networking.send_data(conn, self._ping_reply())
        elif action == "shard_map":
            networking.send_data(conn, self._shard_map_reply())
        elif action == "stats":
            networking.send_data(conn, {"ok": True, "stats": self.stats()})
        elif action == "fence":
            networking.send_data(conn, {
                "ok": True, "epoch": self.fence(int(msg["epoch"]))})
        elif action == "mark_epoch":
            self.mark_epoch(int(msg["epoch"]))
            networking.send_data(conn, {"ok": True})
        elif action == "heartbeat":
            known = self.heartbeat(msg["worker_id"],
                                   retries=msg.get("retries", 0))
            networking.send_data(conn, {"ok": True, "known": known})
        elif action == "deregister":
            self.deregister_worker(msg["worker_id"])
            networking.send_data(conn, {"ok": True})
        elif action == "join":
            rec = self.join_worker(msg["worker_id"])
            rec["ok"] = True
            networking.send_data(conn, rec)
        elif action == "drain":
            self.drain_worker(msg["worker_id"],
                              timeout=bool(msg.get("timeout")))
            networking.send_data(conn, {"ok": True})
        elif action == "replicate_stream":
            return self._serve_replication(conn, msg)
        elif action in ("stop", "bye"):
            return True
        elif action in _LATER_ACTIONS:
            networking.send_data(conn, {
                "ok": False,
                "error": f"action {action!r} is not ported yet: "
                         f"ROADMAP.md {_LATER_ACTIONS[action]}"})
        else:
            networking.send_data(conn, {"error": f"bad action {action}"})
        return False

    def _ping_reply(self) -> dict:
        return {"ok": True, "epoch": self.fence_epoch,
                "num_updates": self.num_updates,
                "standby": bool(getattr(self, "is_standby", False)),
                "shard": self.shard_info}

    def _shard_map_reply(self) -> dict:
        """The shard-map handshake: which shard of which plan this server
        holds (None unsharded) and the fencing epoch the shard-map epoch
        sums."""
        return {"ok": True, "shard": self.shard_info,
                "epoch": self.fence_epoch}

    def _serve_replication(self, conn, msg) -> bool:
        """Only a standby takes a replication stream; True when the
        connection was consumed."""
        networking.send_data(conn, {"ok": False, "error": "not a standby"})
        return False

    def _serve_pull(self, conn, worker_id: int) -> None:
        """The exact pull on the wire: the immutable snapshot is pickled
        straight onto the wire (pickling copies) and counted once sent."""
        with _trace.span("ps.pull"):
            snap, _ = self._begin_pull(worker_id, compressed=False)
            self._begin_reply()
            try:
                networking.send_data(conn, {"weights": snap})
                self._count(pulls=1, bytes_out=self._center_nbytes)
            finally:
                self._end_reply()

    def _serve_compressed_pull(self, conn, worker_id: int) -> None:
        """The int8 pull on the wire: a reply that never went out rolls its
        residual advance back (unless a newer encode raced in)."""
        with _trace.span("ps.pull_int8"):
            snap, st = self._begin_pull(worker_id, compressed=True)
            with st.lock:
                blob, nbytes = self._encode_pull(st, snap)
                epoch = st.epoch
            self._send_blob(conn, {"weights": blob}, st, snap, blob, epoch,
                            nbytes, fused=0)

    def _send_blob(self, conn, reply, st, snap, blob, epoch, nbytes, fused):
        self._begin_reply()
        try:
            networking.send_data(conn, reply)
            self._count(compressed_pulls=1, bytes_out=nbytes, fused=fused)
        except (ConnectionError, OSError):
            with st.lock:
                if st.epoch == epoch:
                    self._rollback_encode_locked(st, snap, blob)
            raise
        finally:
            self._end_reply()

    def _serve_exchange(self, conn, msg, raw: bytes | None) -> None:
        """The fused exchange on the wire: fold + pull bookkeeping (the
        request frame logged verbatim), then the post-fold center (or its
        int8 blob) in the reply."""
        compressed = bool(msg.get("compressed"))
        with _trace.span("ps.exchange"):
            try:
                applied, snap, st = self._commit_impl(
                    msg["worker_id"], msg["payload"], seq=msg.get("seq"),
                    epoch=msg.get("epoch"), wire_frame=raw,
                    lag=bool(msg.get("lag")), fused=True,
                    compressed=compressed)
            except networking.FencedEpochError as fe:
                networking.send_data(conn, {"error": "fenced",
                                            "epoch": fe.server_epoch})
                return
            if not compressed:
                self._begin_reply()
                try:
                    networking.send_data(conn, {"ok": True,
                                                "dup": not applied,
                                                "weights": snap})
                    self._count(pulls=1, bytes_out=self._center_nbytes,
                                fused=1)
                finally:
                    self._end_reply()
                return
            with st.lock:
                blob, nbytes = self._encode_pull(st, snap)
                epoch = st.epoch
            self._send_blob(conn, {"ok": True, "dup": not applied,
                                   "weights": blob}, st, snap, blob, epoch,
                            nbytes, fused=1)

    def stop(self) -> None:
        """Shut down: a self-connect unblocks ``accept`` (the reference's
        ``cancel_accept``), the socket close backs it up, every live
        connection is closed, and the WAL is flushed and closed."""
        if not self._running:
            self._close_durability()
            return
        self._running = False
        try:
            with networking.connect(self.host, self.port, timeout=5) as s:
                networking.send_data(s, {"action": "bye"})
        except OSError:
            pass
        if self._server_sock is not None:
            self._server_sock.close()
        if self._service_thread is not None:
            self._service_thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._close_durability()

    def _crash(self) -> None:
        """Chaos seam: die like a killed process, not a clean stop. The
        listener and every live connection are torn mid-flight and the WAL
        is abandoned without its close-time fsync: whatever each append's
        flush (or an earlier group fsync) made durable survives, nothing
        else, and every deferred-ACK waiter gives up (its client
        replays)."""
        self.crashed_ = True
        self._running = False
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._wal is not None:
            self._wal.abandon()
        sock, self._replica_sock = self._replica_sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class StandbySocketParameterServer(SocketParameterServer):
    """A warm replica: applies the primary's replication stream and serves
    no worker until promoted.

    Construct, ``initialize()`` and ``start()`` it like any socket PS (its
    address is known up front, so failover never waits on a bind); the
    primary's ``attach_standby`` opens the replication connection: one
    full-state frame, then raw WAL-framed records applied in order through
    ``wal.replay_record``, the path crash recovery uses. Worker actions are
    refused with a retryable ``standby`` error until ``promote(epoch)``
    installs the replicated state under the center lock, stamps the new
    fencing epoch and turns it into an ordinary serving PS.

    A replica may have a successor of its own (``attach_standby`` on the
    replica): it then forwards every record it applies, in apply order, so
    a chain primary → r1 → r2 … holds the primary's history in every link
    and survives as many successive primary deaths as it has links
    (``PSFailoverSupervisor`` promotes down it). The spans
    ``ps.chain_apply`` and ``ps.chain_forward`` time the two halves."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 host: str = "127.0.0.1", port: int = 0,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, snapshot_every: int = 100,
                 wal_group_window: int = 8,
                 wal_group_interval: float = 0.25):
        super().__init__(center, rule, num_workers, host=host, port=port,
                         ema_decay=ema_decay,
                         lease_timeout=lease_timeout, wal_dir=wal_dir,
                         snapshot_every=snapshot_every,
                         wal_group_window=wal_group_window,
                         wal_group_interval=wal_group_interval)
        self.is_standby = True
        self._repl_lock = threading.Lock()
        self._repl_state: dict | None = None
        self._repl_records = 0
        self._repl_streaming = False
        self.promoted_ = False

    def _dispatch(self, conn, msg: dict, raw: bytes | None) -> bool:
        if not self.is_standby:
            return super()._dispatch(conn, msg, raw)
        # before promotion only the stream and pings are served; worker
        # operations get a retryable refusal
        action = msg.get("action")
        if action == "replicate_stream":
            return self._serve_replication(conn, msg)
        if action == "ping":
            reply = self._ping_reply()
            # read the state reference once: promote() clears it
            state = self._repl_state
            if state is not None:
                reply["num_updates"] = state["num_updates"]
            networking.send_data(conn, reply)
        elif action == "shard_map":
            networking.send_data(conn, self._shard_map_reply())
        elif action in ("stop", "bye"):
            return True
        else:
            networking.send_data(conn, {"error": "standby",
                                        "standby": True})
        return False

    def _serve_replication(self, conn, msg) -> bool:
        with self._repl_lock:
            self._repl_state = dict(msg["state"])
            self._repl_streaming = True
        networking.send_data(conn, {"ok": True})
        hdr = _wal._HDR
        try:
            # raw records from here on: header + body straight off the
            # socket, no pickle frame around each
            while True:
                head = networking._recv_exact(conn, hdr.size)
                _rec_type, _crc, ln = hdr.unpack(head)
                body = networking._recv_exact(conn, ln, expected=ln)
                recs = list(_wal.iter_records(head + body))
                if not recs:
                    raise networking.ProtocolError(
                        "corrupt replication record", retryable=False)
                with self._repl_lock:
                    if not self.is_standby:
                        return True  # promoted: this stream is history
                    self._repl_records += 1
                    with _trace.span("ps.chain_apply"):
                        _wal.replay_record(self._repl_state, recs[0][0],
                                           recs[0][1], self.rule,
                                           self.num_workers, self.ema_decay)
                    # a middle link of a chain forwards the raw record to
                    # its own successor after applying it, under the same
                    # lock: the order down the chain is the apply order,
                    # which is the primary's fold order
                    self._forward_chain_locked(head, body)
        finally:
            # stream end (the dead primary's kernel flushed and closed):
            # every ACKed record has been applied; promote() waits on this
            with self._repl_lock:
                self._repl_streaming = False

    def _forward_chain_locked(self, head: bytes, body: bytes) -> None:
        """Send one applied record to this link's successor (call under
        ``_repl_lock``; an unpromoted replica folds nothing, so nothing
        else sends on the stream). A failed send drops the successor, as
        the primary's does: the chain shrinks, the apply loop goes on."""
        if self._replica_sock is None:
            return
        with _trace.span("ps.chain_forward"):
            self._send_replica_locked((head, body))

    @contextlib.contextmanager
    def _replication_base(self):
        """A chain link's successor starts from the replicated state when a
        stream already runs, else from this server's own; a group attaches
        its chains tail first before any traffic (``ShardedPSGroup.
        start``), where the two are the same, so the successor misses no
        record. ``_repl_lock`` orders it before every forwarded record.
        Once promoted, the primary's base."""
        if not self.is_standby:
            with super()._replication_base() as state:
                yield state
            return
        with self._repl_lock:
            if self._repl_state is not None:
                yield {k: v for k, v in self._repl_state.items()
                       if k != "replayed"}
            else:
                with self._lock:
                    base = self._capture_state_locked()
                base.setdefault("ema", None)
                self._attach_ema_state(base)
                yield base

    def promote(self, epoch: int, drain_timeout: float = 5.0) -> None:
        """Become the primary: drain the replication stream, install the
        replicated state, stamp the fencing epoch, serve. The primary ACKs
        a commit after sending its record, so ACKed records may still sit
        in this side's socket buffer when it dies: promotion waits for the
        stream's end (a dead primary's kernel closes it) or for one idle
        poll of a still-open stream, bounded by ``drain_timeout``."""
        with _trace.span("ps.promote", args={"epoch": int(epoch)}):
            self._promote_impl(epoch, drain_timeout)

    def _promote_impl(self, epoch: int, drain_timeout: float) -> None:
        deadline = time.monotonic() + float(drain_timeout)
        last = -1
        while time.monotonic() < deadline:
            with self._repl_lock:
                streaming = self._repl_streaming
                applied = self._repl_records
            if not streaming or applied == last:
                break  # stream ended, or idle for one poll
            last = applied
            time.sleep(0.05)
        snap = None
        with self._repl_lock:
            state, self._repl_state = self._repl_state, None
            with self._lock:
                if state is not None:
                    self._adopt_state(state)
                self.fence_epoch = max(self.fence_epoch, int(epoch))
                if self._wal is not None:
                    # the promoted history gets its own durable log
                    self._wal.rotate(self.num_updates)
                    snap = self._capture_state_locked()
            self.is_standby = False
            self.promoted_ = True
        if snap is not None:
            self._attach_ema_state(snap)
            self._wal.publish_snapshot(snap)


class ParameterServerClient:
    """Worker-side proxy speaking the socket protocol, with the in-process
    PS's call surface so workers are transport-agnostic. Payloads must be
    host trees of numpy arrays (or codec blobs): a tensor is refused
    before any frame is built. ``epoch`` is the fencing token carried on
    every commit (None never fenced)."""

    def __init__(self, host: str, port: int, worker_id: int,
                 pull_compression: str | None = None,
                 epoch: int | None = None,
                 connect_timeout: float | None = 30.0,
                 timeout: float | None = 600.0):
        self.pull_compression = validate_pull_compression(pull_compression)
        self.worker_id = worker_id
        self.epoch = None if epoch is None else int(epoch)
        self._sock = networking.connect(host, port, timeout=connect_timeout)
        # a pull may wait behind many commits: bounded, but generously
        self._sock.settimeout(timeout)

    def _request(self, msg: dict) -> dict:
        networking.send_data(self._sock, msg)
        return networking.recv_data(self._sock)

    def _payload_msg(self, action: str, payload, seq) -> dict:
        if not is_encoded(payload):
            payload = _host_payload(payload)
        msg = {"action": action, "worker_id": self.worker_id,
               "payload": payload}
        if _trace.enabled() and (corr := _trace.current_corr()):
            msg["corr"] = corr
        if seq is not None:
            msg["seq"] = int(seq)
        if self.epoch is not None:
            msg["epoch"] = self.epoch
        return msg

    def _check_reply(self, reply, what: str) -> None:
        """Typed refusals: fenced (not retryable against this server), an
        unpromoted standby (retryable), anything else unexpected."""
        err = reply.get("error") if isinstance(reply, dict) else None
        if err == "fenced":
            raise networking.FencedEpochError(
                f"{what} fenced by the server", client_epoch=self.epoch,
                server_epoch=reply.get("epoch"))
        if err == "standby":
            raise networking.ProtocolError(
                "server is an unpromoted standby", retryable=True)
        if what == "commit" and not (isinstance(reply, dict)
                                     and reply.get("ok")):
            raise networking.ProtocolError(f"commit refused: {reply}")
        if what != "commit" and "weights" not in reply:
            raise networking.ProtocolError(
                f"{what} refused: {reply.get('error', reply)}",
                retryable=True)

    def pull(self, worker_id: int | None = None) -> Tree:
        action = "pull_int8" if self.pull_compression == "int8" else "pull"
        reply = self._request({"action": action,
                               "worker_id": self.worker_id})
        self._check_reply(reply, "pull")
        return maybe_decode(reply["weights"])

    def commit(self, worker_id: int | None, payload: Tree,
               seq: int | None = None) -> None:
        """``seq``: the per-worker commit seqno the server folds at most
        once (``resilience.retry``)."""
        ack = self._request(self._payload_msg("commit", payload, seq))
        self._check_reply(ack, "commit")

    def exchange(self, worker_id: int | None, payload: Tree,
                 seq: int | None = None, lag: bool = False) -> Tree:
        """Fused commit + pull: one round trip folds ``payload`` and returns
        the post-fold center, decoded. ``lag=True`` asks the server to price
        τ from this worker's previous pull (the pipelined exchange)."""
        msg = self._payload_msg("exchange", payload, seq)
        if self.pull_compression == "int8":
            msg["compressed"] = True
        if lag:
            msg["lag"] = True
        reply = self._request(msg)
        self._check_reply(reply, "exchange")
        return maybe_decode(reply["weights"])

    def shard_map(self) -> dict | None:
        """The shard-map handshake: the server's shard record
        (``{"shard_id", "num_shards", "ring"}``), or None for a server
        holding an unsharded center. ``sharding.ShardedPSClient`` checks
        it against its plan before first use."""
        return self._request({"action": "shard_map"}).get("shard")

    def ping(self, timeout: float | None = None) -> dict:
        """``{"ok", "epoch", "num_updates", "standby", "shard"}``;
        ``timeout`` bounds just this round trip."""
        old = self._sock.gettimeout()
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            return self._request({"action": "ping"})
        finally:
            self._sock.settimeout(old)

    def fence(self, epoch: int) -> int:
        """Raise the server's fencing epoch; returns the epoch after."""
        reply = self._request({"action": "fence", "epoch": int(epoch)})
        return int(reply.get("epoch", epoch))

    def mark_epoch(self, epoch: int) -> None:
        """Log a training-epoch boundary into the server's WAL and
        replication stream."""
        self._request({"action": "mark_epoch", "epoch": int(epoch)})

    def heartbeat(self, retries: int = 0) -> bool:
        """Renew this worker's lease (auto-registering); ``retries`` is the
        client's cumulative retry count. False when this heartbeat
        (re-)registered the worker."""
        reply = self._request({"action": "heartbeat",
                               "worker_id": self.worker_id,
                               "retries": int(retries)})
        return bool(reply.get("known", False))

    def deregister(self) -> None:
        """A clean exit: drop this worker's lease without an eviction."""
        self._request({"action": "deregister", "worker_id": self.worker_id})

    def join(self) -> dict:
        """Live-join admission: lease this worker mid-run and read the pool
        gauge and the center's version (``{"ok", "pool_size",
        "num_updates"}``). Pull right after: that pull records this
        worker's pull version, so DynSGD prices its first commit at the
        true small τ."""
        reply = self._request({"action": "join",
                               "worker_id": self.worker_id})
        if not reply.get("ok"):
            raise networking.ProtocolError(
                f"join refused: {reply.get('error', reply)}", retryable=True)
        return reply

    def drain(self, timeout: bool = False) -> None:
        """Preemption drain: a clean deregister (the dedup seqno retired)
        plus the server's membership counters; ``timeout=True`` reports a
        drain whose deadline lapsed."""
        self._request({"action": "drain", "worker_id": self.worker_id,
                       "timeout": bool(timeout)})

    def stats(self) -> dict:
        """The server's ``stats()``, settled, over the wire."""
        return self._request({"action": "stats"})["stats"]

    def set_timeout(self, seconds: float | None) -> None:
        self._sock.settimeout(seconds)

    def close(self) -> None:
        try:
            networking.send_data(self._sock, {"action": "bye"})
        except OSError:
            pass
        self._sock.close()


def _host_payload(tree: Tree) -> Tree:
    """A raw commit as it may travel: numpy leaves only."""
    def leaf(x):
        if not isinstance(x, (np.ndarray, np.generic, int, float)):
            raise TypeError(
                f"commit leaves must be numpy arrays, got {type(x)}: turn "
                f"tensors into numpy before they reach the wire")
        return np.asarray(x)

    return utils.host_tree_map(leaf, tree)


__all__ = ["ParameterServer", "SocketParameterServer",
           "StandbySocketParameterServer", "ParameterServerClient",
           "build_ps_stats", "validate_ema_decay"]
