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

Durability (the write-ahead log, the hot standby), leases and heartbeats,
retries with their exactly-once commit dedup, epoch fencing, elastic
membership, sharding and the center's EMA belong to later slices
(``ROADMAP.md`` A7.6–A7.9, A8): their wire actions answer with an error
frame naming the item, and their stats counters stay 0.
"""

from __future__ import annotations

import collections
import pickle
import socket
import threading
import time
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

Tree = Any

#: wire actions of later slices → the ROADMAP item that ports them
_LATER_ACTIONS = {
    "fence": "A7.6 (resilience: fencing, WAL, standby)",
    "mark_epoch": "A7.6 (resilience: fencing, WAL, standby)",
    "replicate_stream": "A7.6 (resilience: fencing, WAL, standby)",
    "heartbeat": "A7.6 (resilience: leases and heartbeats)",
    "deregister": "A7.6 (resilience: leases and heartbeats)",
    "join": "A7.8 (elastic membership)",
    "drain": "A7.8 (elastic membership)",
    "shard_map": "A7.7 (sharding)",
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
    """One queued commit (or fused exchange) awaiting the fold drain; the
    locked section's outputs travel back to the submitting thread."""

    __slots__ = ("worker_id", "payload", "lag", "fused", "compressed", "corr",
                 "done", "exc", "snap_out", "st", "batched")

    def __init__(self, worker_id, payload, lag, fused, compressed, corr):
        self.worker_id = worker_id
        self.payload = payload
        self.lag = lag
        self.fused = fused
        self.compressed = compressed
        self.corr = corr
        self.done = threading.Event()
        self.exc: BaseException | None = None
        self.snap_out = None
        self.st = None
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


def _is_floatish(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.floating)


class ParameterServer:
    """In-process center variable with per-algorithm fold semantics; the
    shared PS of same-process worker threads (``ps_transport=
    "inprocess"``) and the base of :class:`SocketParameterServer`."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int):
        self.center = utils.tree_to_numpy(center)
        self.rule = rule
        self.num_workers = int(num_workers)
        self.num_updates = 0
        self._lock = _TimedLock()
        self._pull_versions: dict[int, int] = {}
        # the version each worker's pull recorded before its latest one:
        # every record shifts cur → prev (center lock)
        self._prev_pull_versions: dict[int, int] = {}
        self._fold_mu = threading.Lock()
        self._fold_pending: list[_FoldWork] = []
        self._pull_errors: dict[int, _PullState] = {}
        self._stats_lock = threading.Lock()
        self._n_pending_replies = 0
        self._n_pulls = 0
        self._n_compressed_pulls = 0
        self._n_commits = 0
        self._n_fused = 0
        self._n_batched_folds = 0
        self._bytes_in = 0
        self._bytes_out = 0
        self._t_start = time.monotonic()
        self._center_nbytes = sum(
            np.asarray(leaf).nbytes for leaf in utils.flatten(self.center)[0])
        self._tau_recent: collections.deque = collections.deque(maxlen=512)

    # -- service lifecycle (no-ops for the in-process PS) --------------------

    def initialize(self) -> None:
        pass

    def run(self) -> None:
        pass

    def stop(self) -> None:
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
        the version, take the immutable snapshot, resolve the residual."""
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

    def commit(self, worker_id: int, payload: Tree) -> bool:
        """Fold one worker's commit into the center (decoded first when it
        arrives codec-compressed). Every commit folds: the exactly-once
        dedup of replayed commits comes with retries (A7.6). Returns True,
        as the reference does for a commit it folded."""
        self._commit_impl(worker_id, payload)
        return True

    def exchange(self, worker_id: int, payload: Tree, lag: bool = False,
                 compressed: bool = False) -> tuple:
        """Fused commit + pull under one center-lock section: the fold is
        priced as a commit would be, then the pull version is recorded at
        the post-fold ``num_updates``. ``lag=True`` (the pipelined worker)
        prices τ from the previous recorded pull version instead. Returns
        ``(center copy or int8 blob, True)``, the reference's ``(weights,
        applied)``."""
        snap, st = self._commit_impl(worker_id, payload, lag=lag, fused=True,
                                     compressed=compressed)
        if not compressed:
            out = _tree_copy(snap)  # O(model), off the center lock
            self._count(pulls=1, bytes_out=self._center_nbytes, fused=1)
            return out, True
        with st.lock:
            blob, nbytes = self._encode_pull(st, snap)
        self._count(compressed_pulls=1, bytes_out=nbytes, fused=1)
        return blob, True

    def _commit_impl(self, worker_id: int, payload: Tree, lag: bool = False,
                     fused: bool = False, compressed: bool = False) -> tuple:
        """Decode off the lock, fold through the batched drain, count the
        commit side. Returns ``(snap, st)``: the fused pull's snapshot and
        residual state (None unless ``fused``)."""
        nbytes = self._payload_nbytes(payload)  # wire size: BEFORE decode
        with _trace.span("ps.decode"):
            payload = maybe_decode(payload)
        work = _FoldWork(worker_id, payload, lag, fused, compressed,
                         _trace.current_corr() if _trace.enabled() else None)
        self._enqueue_and_fold(work)
        if work.exc is not None:
            raise work.exc
        self._count(commits=1, bytes_in=nbytes,
                    batched_folds=1 if work.batched else 0)
        return work.snap_out, work.st

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
        """One commit's center-lock section; always sets ``work.done``."""
        t0 = time.perf_counter_ns()
        worker_id = work.worker_id
        try:
            if work.lag and worker_id in self._prev_pull_versions:
                # the pipelined delta was computed from the center of one
                # exchange ago: price τ from the previous pull version
                pull_version = self._prev_pull_versions[worker_id]
            else:
                pull_version = self._pull_versions.get(worker_id, 0)
            staleness = self.num_updates - pull_version
            self._tau_recent.append(int(staleness))
            self.center = utils.tree_to_numpy(self.rule.fold(
                self.center, work.payload, self.num_workers, staleness))
            self.num_updates += 1
            if work.fused:
                self._record_pull_locked(worker_id)
                work.snap_out = self.center
                if work.compressed:
                    st = self._pull_errors.get(worker_id)
                    if st is None:
                        st = self._pull_errors[worker_id] = _PullState()
                    work.st = st
        except BaseException as e:  # carried to the submitting thread
            work.exc = e
        finally:
            if _trace.enabled():
                _trace.record("ps.fold", t0, time.perf_counter_ns(),
                              corr=work.corr)
            work.done.set()

    def get_model(self) -> Tree:
        with self._lock:
            snap = self.center
        return _tree_copy(snap)  # the snapshot is immutable: copy off-lock

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
               bytes_out=0, fused=0, batched_folds=0):
        with self._stats_lock:
            self._n_pulls += pulls
            self._n_compressed_pulls += compressed_pulls
            self._n_commits += commits
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
        """Contention and throughput counters (``build_ps_stats``'s keys;
        the dedup, fencing, lease, WAL, membership and deploy counters stay
        0 until their slices)."""
        if settle:
            self._settle_stats()
        elapsed = time.monotonic() - self._t_start
        with self._stats_lock:
            counts = (self._n_pulls, self._n_compressed_pulls,
                      self._n_commits, self._bytes_in, self._bytes_out)
            fusedx, batched = self._n_fused, self._n_batched_folds
        return build_ps_stats(
            *counts, self._lock.acquires, self._lock.wait_ns,
            self._lock.hold_ns, elapsed, num_updates=self.num_updates, pool_size=self.num_workers,
            fused_exchanges=fusedx, batched_folds=batched)


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
    ``stats``, ``ping`` and ``stop``/``bye``."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(center, rule, num_workers)
        self.host = host
        self.port = int(port)
        self._server_sock: socket.socket | None = None
        self._service_thread: threading.Thread | None = None
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self._running = False

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
                msg = networking.recv_data(conn)
                action = msg.get("action")
                if _trace.enabled():
                    _trace.set_corr(msg.get("corr"))
                if action == "pull":
                    self._serve_pull(conn, msg["worker_id"])
                elif action == "pull_int8":
                    self._serve_compressed_pull(conn, msg["worker_id"])
                elif action == "commit":
                    self.commit(msg["worker_id"], msg["payload"])
                    networking.send_data(conn, {"ok": True, "dup": False})
                elif action == "exchange":
                    self._serve_exchange(conn, msg)
                elif action == "ping":
                    networking.send_data(conn, {
                        "ok": True, "epoch": 0,
                        "num_updates": self.num_updates, "standby": False,
                        "shard": None})
                elif action == "stats":
                    networking.send_data(conn, {"ok": True,
                                                "stats": self.stats()})
                elif action in ("stop", "bye"):
                    break
                elif action in _LATER_ACTIONS:
                    networking.send_data(conn, {
                        "ok": False,
                        "error": f"action {action!r} is not ported yet: "
                                 f"ROADMAP.md {_LATER_ACTIONS[action]}"})
                else:
                    networking.send_data(conn,
                                         {"error": f"bad action {action}"})
        except (ConnectionError, EOFError, OSError, pickle.UnpicklingError):
            # a peer gone, or a hostile frame the restricted unpickler
            # refused: drop the connection quietly
            pass
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

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

    def _serve_exchange(self, conn, msg) -> None:
        """The fused exchange on the wire: fold + pull bookkeeping, then the
        post-fold center (or its int8 blob) in the reply."""
        compressed = bool(msg.get("compressed"))
        with _trace.span("ps.exchange"):
            snap, st = self._commit_impl(msg["worker_id"], msg["payload"],
                                         lag=bool(msg.get("lag")), fused=True,
                                         compressed=compressed)
            if not compressed:
                self._begin_reply()
                try:
                    networking.send_data(conn, {"ok": True, "dup": False,
                                                "weights": snap})
                    self._count(pulls=1, bytes_out=self._center_nbytes,
                                fused=1)
                finally:
                    self._end_reply()
                return
            with st.lock:
                blob, nbytes = self._encode_pull(st, snap)
                epoch = st.epoch
            self._send_blob(conn, {"ok": True, "dup": False,
                                   "weights": blob}, st, snap, blob, epoch,
                            nbytes, fused=1)

    def stop(self) -> None:
        """Shut down: a self-connect unblocks ``accept`` (the reference's
        ``cancel_accept``), the socket close backs it up, and every live
        connection is closed."""
        if not self._running:
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


class ParameterServerClient:
    """Worker-side proxy speaking the socket protocol, with the in-process
    PS's call surface so workers are transport-agnostic. Payloads must be
    host trees of numpy arrays (or codec blobs): a tensor is refused
    before any frame is built."""

    def __init__(self, host: str, port: int, worker_id: int,
                 pull_compression: str | None = None,
                 connect_timeout: float | None = 30.0,
                 timeout: float | None = 600.0):
        self.pull_compression = validate_pull_compression(pull_compression)
        self.worker_id = worker_id
        self._sock = networking.connect(host, port, timeout=connect_timeout)
        # a pull may wait behind many commits: bounded, but generously
        self._sock.settimeout(timeout)

    def _request(self, msg: dict) -> dict:
        networking.send_data(self._sock, msg)
        return networking.recv_data(self._sock)

    def _payload_msg(self, action: str, payload) -> dict:
        if not is_encoded(payload):
            payload = _host_payload(payload)
        msg = {"action": action, "worker_id": self.worker_id,
               "payload": payload}
        if _trace.enabled() and (corr := _trace.current_corr()):
            msg["corr"] = corr
        return msg

    def pull(self, worker_id: int | None = None) -> Tree:
        action = "pull_int8" if self.pull_compression == "int8" else "pull"
        reply = self._request({"action": action,
                               "worker_id": self.worker_id})
        if "weights" not in reply:
            raise networking.ProtocolError(
                f"pull refused: {reply.get('error', reply)}", retryable=True)
        return maybe_decode(reply["weights"])

    def commit(self, worker_id: int | None, payload: Tree) -> None:
        ack = self._request(self._payload_msg("commit", payload))
        if not (isinstance(ack, dict) and ack.get("ok")):
            raise networking.ProtocolError(f"commit refused: {ack}")

    def exchange(self, worker_id: int | None, payload: Tree,
                 lag: bool = False) -> Tree:
        """Fused commit + pull: one round trip folds ``payload`` and returns
        the post-fold center, decoded. ``lag=True`` asks the server to price
        τ from this worker's previous pull (the pipelined exchange)."""
        msg = self._payload_msg("exchange", payload)
        if self.pull_compression == "int8":
            msg["compressed"] = True
        if lag:
            msg["lag"] = True
        reply = self._request(msg)
        if "weights" not in reply:
            raise networking.ProtocolError(
                f"exchange refused: {reply.get('error', reply)}",
                retryable=True)
        return maybe_decode(reply["weights"])

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
           "ParameterServerClient", "build_ps_stats"]
