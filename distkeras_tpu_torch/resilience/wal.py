"""Durable PS state: write-ahead commit log, snapshots and replay.

Port of ``distkeras_tpu/resilience/wal.py``, byte-compatible with it: a
log either package writes, the other recovers. Every state-changing event
on the parameter server (deduplicated commit folds, pull-version records,
clean deregisters, evictions, fencing-epoch bumps) is appended to a
write-ahead log BEFORE the client sees an ACK, and the full state (center,
``num_updates``, per-worker pull versions, the commit-dedup table, the
fencing epoch) is periodically written as an fsync'd snapshot that
truncates the log. A restarted PS loads ``(snapshot, wal)`` and replays,
reconstructing the state a never-crashed server holds after the same
prefix of events, bit for bit.

Records carry full payloads, not digests: replay re-runs ``rule.fold`` on
the decoded commit to land on the same bits. Each record's frame carries a
CRC32 (split-checksum commits: a CRC over a fixed prefix and an adler32
over the payload), the torn-write detector: a crash mid-append leaves a
tail record that fails its checksum, and replay stops at the durable
prefix.

Crash-consistency contract:

- Appends happen in fold order (the PS appends under its center lock).
  ``group_window`` 1 flushes each record to the OS before the immediate
  ACK and fsyncs periodically; a group window > 1 defers each commit's
  ACK until a flusher thread has batched a window of commits onto ONE
  ``fsync`` (an ACK then implies fsync'd); 0 acknowledges at once and
  fsyncs on the interval. In every mode the flusher bounds the durability
  window in seconds (``group_interval``).
- A commit folded in memory but torn in the log never had its ACK sent:
  the client replays it with the same seqno against the recovered server,
  whose replayed dedup table does not hold it, and it folds once.
- Snapshots go to a temporary name, are fsync'd and atomically renamed;
  only then are older segments and snapshots deleted.

The same record stream is the hot standby's replication wire: the primary
sends each appended record to the replica before ACKing, and the standby
applies it through :func:`replay_record`, the one definition of "apply an
event" for disk and stream alike.

The center's EMA (``ema_decay``) rides the same path: a snapshot carries
``ema`` and ``ema_version``, and replay refolds it after every commit above
that version with the live server's arithmetic (numpy ops for a pickle
commit, the C++ core's f32 ``d·e + (1−d)·c`` for a flat native one), so a
recovered EMA is the live one, bit for bit.
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Iterator

import numpy as np

Pytree = Any

# record types — pickle-bodied (the Python PS's original set)
REC_COMMIT = 1    # (worker_id, seq|None, pull_version, version, payload)
REC_PULL = 2      # (worker_id, version)
REC_DEREG = 3     # (worker_id,)          clean exit: clear dedup entry
REC_EVICT = 4     # (worker_ids,)         lease lapse: clear pulls + dedup
REC_FENCE = 5     # (epoch,)              fencing-epoch bump
# split-checksum commit (the off-lock encode): body = 32-byte
# binary prefix (worker, seq, pull_version, version, adler32(payload)) +
# the pickled payload bytes. The frame header's CRC covers ONLY the
# prefix, so the O(model) payload checksum is computed BEFORE the center
# lock and the lock's critical section appends pre-encoded chunks — it
# never hashes or copies the payload. (adler32, not crc32, for the bulk
# payload: ~3x faster in CPython and ~10x with the native SSSE3 kernel —
# on the durable hot path the hash IS the cost; its weaker mixing is fine
# for the job here, detecting torn/partial tails.) Replay semantics are
# identical to REC_COMMIT.
REC_COMMIT2 = 6
# flat native records (written by native/dkps.cpp — no pickle anywhere):
# binary little-endian bodies the C++ server can frame with memcpy.
REC_COMMIT_FLAT = 7   # prefix(worker, seq, pull_version, version, scale,
#                       adler32(payload)) + raw f32 LE payload; replay
#                       folds center += payload * f32(scale) — the exact
#                       saxpy the C++ fold ran, so replay is bit-identical
REC_PULL_FLAT = 8     # u32 worker, u64 version
REC_DEREG_FLAT = 9    # u32 worker
REC_EVICT_FLAT = 10   # u32 count + count * u32 workers
REC_FENCE_FLAT = 11   # u64 epoch
# wire-frame commit: the payload bytes are the commit's ENTIRE pickled
# request frame exactly as it crossed the socket — the server logs the
# bytes it already has instead of re-serializing the tree (a whole
# O(model) pickle pass saved per durable commit). Replay re-runs the
# live path's exact pipeline: restricted-unpickle -> ["payload"] ->
# maybe_decode -> tree_to_numpy -> rule.fold.
REC_COMMIT_WIRE = 12
# membership-directory records (directory/service.py): the replicated
# (role, key) -> (endpoint, epoch, lease) map logs its state changes
# through the SAME record framing — pickle-bodied tuples, each carrying
# the post-apply version so replay detects gaps exactly like the PS log.
# Lease RENEWALS are deliberately NOT logged (liveness is runtime state,
# like PS heartbeats); expirations ARE (they change the map).
REC_DIR_PUT = 20       # (role, key, host, port, epoch, meta, ttl, version)
REC_DIR_DEL = 21       # (role, key, epoch, version)
REC_DIR_EXPIRE = 22    # ([(role, key), ...], version)
REC_DIR_FENCE = 23     # (epoch, version)
# training-epoch boundary marker (deploy streaming): logged by the PS
# when the trainer's epoch barrier completes, so downstream read replicas
# see epoch edges IN the replication stream (ordered against the folds)
# instead of guessing from fold counts. Does not mutate recoverable PS
# state beyond an advisory mark — old logs without it replay unchanged.
REC_EPOCH = 24         # (epoch,)

_HDR = struct.Struct(">BII")  # type, crc32(body or prefix), len(body)
# split-checksum prefixes (little-endian: the native writer memcpy's
# x86 fields); the trailing u32 is adler32(payload)
_CMT2 = struct.Struct("<IqQQI")    # wid, seq(-1=None), pull_v, v, adler
_CMTF = struct.Struct("<IqQQfI")   # + f32 fold scale before the adler
_PULLF = struct.Struct("<IQ")
_DEREGF = struct.Struct("<I")
_FENCEF = struct.Struct("<Q")

_SNAP_PREFIX = "snap-"
_SNAP_SUFFIX = ".dkw"
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _restricted_loads(data: bytes):
    """Decode a record/snapshot body with the same primitives+numpy-only
    unpickler the wire uses (networking._RestrictedUnpickler): WAL files
    live on shared filesystems, so they get the same defense the frames
    do — a tampered log can corrupt training state, not execute code."""
    from distkeras_tpu_torch.networking import _RestrictedUnpickler

    return _RestrictedUnpickler(io.BytesIO(data)).load()


def encode_record(rec_type: int, body_obj: Any) -> bytes:
    """Frame one record: header(type, crc32, len) + pickled body."""
    body = pickle.dumps(body_obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _HDR.pack(rec_type, zlib.crc32(body), len(body)) + body


def encode_commit_chunks(worker_id: int, seq: int | None, pull_version: int,
                         version: int, payload_bytes: bytes,
                         payload_sum: int,
                         rec_type: int = REC_COMMIT2) -> tuple[bytes, bytes]:
    """Frame a commit (REC_COMMIT2 / REC_COMMIT_WIRE) as
    ``(header+prefix, payload_bytes)`` chunks.

    The caller computed ``payload_sum = zlib.adler32(payload_bytes)`` OFF
    the center lock; this function is O(1) and safe to call inside the
    fold's critical section (pull_version/version are lock-determined).
    The two chunks are written back-to-back — kept separate so the append
    never copies the O(model) payload into a joined buffer.
    """
    prefix = _CMT2.pack(int(worker_id), -1 if seq is None else int(seq),
                        int(pull_version), int(version),
                        payload_sum & 0xFFFFFFFF)
    hdr = _HDR.pack(rec_type, zlib.crc32(prefix),
                    _CMT2.size + len(payload_bytes))
    return hdr + prefix, payload_bytes


def _validate_body(rec_type: int, body, crc: int) -> bool:
    """Is this frame's body intact? Split-checksum commits (types 6/7/12)
    carry the O(model) payload adler32 inside their fixed-size prefix —
    the header CRC covers only the prefix — so both halves are checked."""
    if rec_type in (REC_COMMIT2, REC_COMMIT_WIRE):
        if len(body) < _CMT2.size or zlib.crc32(body[:_CMT2.size]) != crc:
            return False
        psum = _CMT2.unpack_from(body)[4]
        return zlib.adler32(body[_CMT2.size:]) == psum
    if rec_type == REC_COMMIT_FLAT:
        if len(body) < _CMTF.size or zlib.crc32(body[:_CMTF.size]) != crc:
            return False
        psum = _CMTF.unpack_from(body)[5]
        return zlib.adler32(body[_CMTF.size:]) == psum
    return zlib.crc32(body) == crc


def _decode_body(rec_type: int, body: bytes) -> Any:
    """Decode a validated body into the replay tuple for its type."""
    if rec_type in (REC_COMMIT2, REC_COMMIT_WIRE):
        wid, seq, pull_v, v, _ = _CMT2.unpack_from(body)
        return (wid, None if seq < 0 else seq, pull_v, v,
                body[_CMT2.size:])
    if rec_type == REC_COMMIT_FLAT:
        wid, seq, pull_v, v, scale, _ = _CMTF.unpack_from(body)
        payload = np.frombuffer(body, dtype="<f4", offset=_CMTF.size)
        return (wid, None if seq < 0 else seq, pull_v, v,
                np.float32(scale), payload)
    if rec_type == REC_PULL_FLAT:
        return _PULLF.unpack(body)
    if rec_type == REC_DEREG_FLAT:
        return _DEREGF.unpack(body)
    if rec_type == REC_EVICT_FLAT:
        (count,) = struct.unpack_from("<I", body)
        return (list(struct.unpack_from(f"<{count}I", body, 4)),)
    if rec_type == REC_FENCE_FLAT:
        return _FENCEF.unpack(body)
    return _restricted_loads(body)


def durable_prefix_len(data: bytes) -> int:
    """Byte length of the valid record prefix (where a torn/corrupt tail
    starts, if any)."""
    off = 0
    n = len(data)
    while off + _HDR.size <= n:
        rec_type, crc, ln = _HDR.unpack_from(data, off)
        body_off = off + _HDR.size
        if body_off + ln > n or not _validate_body(
                rec_type, data[body_off:body_off + ln], crc):
            return off
        off = body_off + ln
    return off


def iter_records(data: bytes) -> Iterator[tuple[int, Any]]:
    """Yield (type, body) records from a segment's bytes, stopping at the
    first torn or corrupt frame (the durable prefix ends there)."""
    off = 0
    n = len(data)
    while off + _HDR.size <= n:
        rec_type, crc, ln = _HDR.unpack_from(data, off)
        body_off = off + _HDR.size
        if body_off + ln > n:
            return  # torn tail: the append died mid-write
        body = data[body_off:body_off + ln]
        if not _validate_body(rec_type, body, crc):
            return  # corrupt tail (or bit rot): stop at the durable prefix
        try:
            yield rec_type, _decode_body(rec_type, body)
        except Exception:
            return  # undecodable body: same treatment as a bad CRC
        off = body_off + ln


class CommitLog:
    """Append-only WAL + snapshot manager for one parameter server.

    Files in ``directory``:

    - ``wal-<version>.log`` — records appended since the state was at
      ``version`` (the segment's base). Exactly one live segment.
    - ``snap-<version>.dkw`` — fsync'd full-state snapshot at ``version``.

    Appends are NOT thread-safe by themselves — the PS calls them under
    its center lock, which is also what guarantees the log order equals
    the fold order (replay depends on it).

    Durability modes (``group_window``, group commit):

    - ``1``: every append flushes to the OS before
      the caller ACKs (process-kill safe) and fsync runs periodically
      (``fsync_every`` records — machine-crash bound).
    - ``> 1``: **group commit** — appends stay buffered and commit
      callers block in :meth:`wait_durable` until the flusher thread has
      batched their records (up to ``group_window`` commits, released
      eagerly whenever a waiter exists) onto ONE ``fsync``. An ACK now
      implies *fsynced*, strictly stronger than mode 1, at ~1/group the
      sync cost.
    - ``0``: time-bounded async — appends stay buffered, callers never
      wait, and the flusher fsyncs at least every ``group_interval``
      seconds. The weakest mode: a crash can lose up to ``interval``
      seconds of ACKed commits (the dedup layer makes *replayed* tails
      safe, but an ACKed-and-lost commit is never replayed). For
      benchmarking the durability/latency frontier.

    In every mode the flusher thread enforces the time deadline: records
    appended by a pull-/heartbeat-heavy quiet period (which never trips
    the commit-count heuristics) are fsync'd within ``group_interval``
    seconds — the durability window is bounded in seconds, not commits.
    """

    def __init__(self, directory: str, snapshot_every: int = 100,
                 fsync_every: int = 64, group_window: int = 1,
                 group_interval: float = 0.25):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.snapshot_every = int(snapshot_every)
        self.fsync_every = max(1, int(fsync_every))
        self.group_window = max(0, int(group_window))
        self.group_interval = float(group_interval)
        if self.group_interval <= 0:
            raise ValueError(
                f"group_interval must be positive, got {group_interval}"
            )
        self._fh = None
        self._since_fsync = 0
        self.commits_since_snapshot = 0
        self._segment_base = 0
        # -- group-commit state (all guarded by _cond's lock) --------------
        self._cond = threading.Condition()
        self._appended = 0          # records accepted (queued or written)
        self._durable = 0           # records known fsync'd
        self._commits_appended = 0  # commit records among _appended
        self._commits_durable = 0
        self._waiters = 0           # commit callers blocked in wait_durable
        self._first_pending_t: float | None = None
        self._seg_written = 0       # bytes accepted for the live segment
        self._seg_durable = 0       # bytes of it known fsync'd
        self._abandoned = False     # crash seam: wake waiters, stop syncing
        self._running = True
        # group modes queue CHUNK REFS here (bytes are immutable — the
        # fold path's "append" is an O(1) list append, no copy, no I/O);
        # the flusher drains, writes, and fsyncs. Writers (flusher /
        # sync / rotate / close) serialize on _io_lock, which appenders
        # NEVER take — the fold path cannot block behind an fsync.
        self._queue: list[tuple[bytes, ...]] = []
        self._io_lock = threading.Lock()
        # write-behind cap: with no waiters (window 0) the queue must not
        # grow past this many unsynced bytes before the flusher kicks in
        self._max_queued_bytes = 64 * 1024 * 1024
        # observability (stats() parity keys on both transports)
        self.wal_records = 0
        self.wal_fsyncs = 0
        self.bytes_written = 0      # records and snapshots handed the OS
        self.wal_group_max = 0      # most commits ever released by one fsync
        # recent write+fsync durations in ms (bounded ring, appended by
        # the flusher thread only), for an fsync-tail watch (ROADMAP.md
        # A13). A deque append is O(1) and the flusher owns the clock.
        self.fsync_ms_recent: collections.deque = collections.deque(
            maxlen=256
        )
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True,
            name="dk-wal-flusher",
        )
        self._flusher.start()

    @property
    def group_mode(self) -> bool:
        """True when commit ACKs are deferred to the group fsync."""
        return self.group_window > 1

    @property
    def durable_offset(self) -> int:
        """Bytes of the LIVE segment known fsync'd — everything past this
        offset could vanish in a machine crash (the chaos tests truncate
        here to simulate exactly that)."""
        with self._cond:
            return self._seg_durable

    # -- append side ---------------------------------------------------------

    def open_segment(self, base_version: int) -> None:
        """Open (appending) the live segment based at ``base_version``.
        An existing file (restart-in-place) is first truncated to its
        durable prefix — appending after a torn tail record would bury
        every new record behind an unreadable frame."""
        self._close_segment()
        self._segment_base = int(base_version)
        path = os.path.join(
            self.dir, f"{_SEG_PREFIX}{base_version:012d}{_SEG_SUFFIX}"
        )
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            good = durable_prefix_len(data)
            if good != len(data):
                with open(path, "r+b") as f:
                    f.truncate(good)
        self._fh = open(path, "ab")
        with self._cond:
            self._seg_written = 0
            self._seg_durable = 0

    def append(self, record: bytes, commit: bool = False) -> int:
        """Append one pre-framed record; returns a token for
        :meth:`wait_durable`. Mode 1 writes+flushes to the OS here
        (crash-of-process safe before the immediate ACK); group modes
        only queue the immutable bytes for the flusher — O(1), no copy,
        no I/O, because this runs under the PS center lock."""
        return self.append_chunks((record,), commit=commit)

    def append_chunks(self, chunks: tuple[bytes, ...],
                      commit: bool = True) -> int:
        """Append one record supplied as pre-encoded chunks (header+prefix,
        payload) WITHOUT joining or copying them — the center lock's
        append must stay O(1) in the payload size. Same return/flush
        semantics as :meth:`append`."""
        nbytes = 0
        if self.group_window == 1:
            # window 1: hand the bytes to the OS before the caller
            # ACKs; fsync stays periodic (maybe_fsync / the flusher's
            # time deadline)
            for chunk in chunks:
                self._fh.write(chunk)
                nbytes += len(chunk)
            self._fh.flush()
            self._since_fsync += 1
            self.bytes_written += nbytes
            queued = None
        else:
            for chunk in chunks:
                nbytes += len(chunk)
            queued = tuple(chunks)
        with self._cond:
            if queued is not None:
                self._queue.append(queued)
            self._appended += 1
            self.wal_records += 1
            self._seg_written += nbytes
            if commit:
                self._commits_appended += 1
            if self._first_pending_t is None:
                self._first_pending_t = time.monotonic()
            token = self._appended
            self._cond.notify_all()
        return token

    def wait_durable(self, token: int, timeout: float = 30.0) -> bool:
        """Block until record ``token`` is fsync'd (group mode's deferred
        ACK). Returns False when the log was abandoned/closed first (the
        crash seam) or the timeout lapsed — the caller's connection is
        torn either way, so there is nothing meaningful to ACK."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._waiters += 1
            self._cond.notify_all()  # an eager flusher syncs for waiters
            try:
                while (self._durable < token and self._running
                       and not self._abandoned and self._fh is not None):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self._cond.wait(min(left, 0.1))
                return self._durable >= token
            finally:
                self._waiters -= 1

    def maybe_fsync(self) -> None:
        """Periodic machine-crash durability — call OFF the center lock
        (every ``fsync_every`` records trips a real fsync). Mode-1 path;
        the group flusher owns fsync scheduling otherwise."""
        if not self.group_mode and self._since_fsync >= self.fsync_every:
            self.sync()

    def append_commit(self, worker_id: int, seq: int | None,
                      pull_version: int, version: int,
                      payload_bytes: bytes,
                      payload_sum: int | None = None) -> int:
        """``payload_bytes`` is the pre-pickled decoded commit tree and
        ``payload_sum`` its ``zlib.adler32`` (the checksum the reader
        validates) — BOTH computed OUTSIDE the center lock by the PS
        (the O(model) encode+hash must not ride the fold's critical
        section). This call is O(1) + the queue/buffer append. Returns
        the :meth:`wait_durable` token."""
        if payload_sum is None:
            payload_sum = zlib.adler32(payload_bytes)
        token = self.append_chunks(encode_commit_chunks(
            worker_id, seq, pull_version, version, payload_bytes,
            payload_sum,
        ))
        self.commits_since_snapshot += 1
        return token

    def append_pull(self, worker_id: int, version: int) -> None:
        self.append(encode_record(REC_PULL, (int(worker_id), int(version))))

    def append_dereg(self, worker_id: int) -> None:
        self.append(encode_record(REC_DEREG, (int(worker_id),)))

    def append_evict(self, worker_ids: list[int]) -> None:
        self.append(encode_record(REC_EVICT, ([int(w) for w in worker_ids],)))

    def append_fence(self, epoch: int) -> None:
        # the PS syncs right after releasing its lock: a fence must be
        # durable by the time the fencing caller gets its ack
        self.append(encode_record(REC_FENCE, (int(epoch),)))

    def _flush_loop(self) -> None:
        """The group-commit flusher: batch appended records onto one
        ``fsync`` and release every waiter at once. Sync triggers:

        - a waiter exists (eager — the first committer "leads" the group
          and everyone who appended meanwhile rides its fsync, the classic
          leader/follower group commit);
        - ``group_window`` commits are pending (batch cap);
        - the oldest pending record is ``group_interval`` old (the
          time-based durability bound — covers commit-free quiet periods
          in EVERY mode, including 0 and 1).
        """
        while True:
            with self._cond:
                while self._running:
                    if self._appended > self._durable and not self._abandoned:
                        pending_commits = (self._commits_appended
                                           - self._commits_durable)
                        age = (time.monotonic() - self._first_pending_t
                               if self._first_pending_t is not None else 0.0)
                        if (self._waiters > 0
                                or (self.group_mode
                                    and pending_commits >= self.group_window)
                                or (self._seg_written - self._seg_durable
                                    >= self._max_queued_bytes)
                                or age >= self.group_interval):
                            break
                        self._cond.wait(
                            max(0.001, self.group_interval - age))
                    else:
                        self._cond.wait(self.group_interval)
                if not self._running:
                    return
            if not self._drain_and_sync():
                time.sleep(0.005)  # rotation/crash race: re-evaluate

    def _drain_and_sync(self) -> bool:
        """Write every queued record to the live segment and fsync it;
        publish durability (waking deferred-ACK waiters). Writers —
        flusher, :meth:`sync`, segment close — serialize on ``_io_lock``,
        so a drained batch is always fully written and fsync'd before
        any segment swap; appenders never touch ``_io_lock``."""
        with self._io_lock:
            return self._write_queue_io_locked()

    def _write_queue_io_locked(self) -> bool:
        """The drain body — call with ``_io_lock`` held. A write/fsync
        failure ABANDONS the log (same as the C++ twin): the swapped
        batch is already out of the queue, so carrying on would let a
        later successful drain publish durability past the lost records
        — phantom-durable ACKed commits missing from the log. Abandoning
        instead means no ACK ever goes out for them and their clients
        replay against whatever IS durable."""
        with self._cond:
            if self._abandoned:
                return False
            batch = self._queue
            self._queue = []
            n = self._appended
            n_commits = self._commits_appended
            seg_bytes = self._seg_written
            fh = self._fh
        if fh is None:
            return False
        try:
            # the group-fsync span: in a stitched timeline this is the
            # flusher-thread segment a deferred-ACK commit waits on
            # (ps.wal_wait on the handler thread ends when this closes)
            from distkeras_tpu_torch.observability import trace as _trace

            t_sync = time.perf_counter()
            with _trace.span("wal.fsync", args={"batch": len(batch)}):
                for chunks in batch:
                    for chunk in chunks:
                        fh.write(chunk)
                        self.bytes_written += len(chunk)
                fh.flush()
                os.fsync(fh.fileno())
            self.fsync_ms_recent.append(
                (time.perf_counter() - t_sync) * 1e3
            )
        except (OSError, ValueError):
            # _io_lock is held, so this is not a close/rotate race — the
            # device genuinely failed the write: abandon (see docstring)
            with self._cond:
                self._abandoned = True
                self._running = False
                self._cond.notify_all()
            return False
        self._since_fsync = 0
        self._publish_durable(n, n_commits, seg_bytes)
        return True

    def sync(self) -> None:
        """Drain + flush + fsync now (fence durability, shutdown, the
        mode-1 periodic fsync) — runs OFF the center lock by design."""
        self._drain_and_sync()

    def _publish_durable(self, n: int, n_commits: int,
                         seg_bytes: int) -> None:
        with self._cond:
            if n > self._durable:
                self.wal_group_max = max(
                    self.wal_group_max, n_commits - self._commits_durable
                )
                self._durable = n
                self._commits_durable = max(self._commits_durable, n_commits)
                self._seg_durable = max(self._seg_durable, seg_bytes)
            self.wal_fsyncs += 1
            if self._durable == self._appended:
                self._first_pending_t = None
            self._cond.notify_all()

    def should_snapshot(self) -> bool:
        return (self.snapshot_every > 0
                and self.commits_since_snapshot >= self.snapshot_every)

    def rotate(self, version: int) -> None:
        """Phase 1 of a snapshot — MUST run under the PS center lock, at
        the moment the state is captured at ``version``: open a fresh
        segment so every later record lands post-snapshot. The old
        segment is flushed+fsync'd by the close (releasing any deferred
        ACKs riding it) and stays on disk until the snapshot is durable —
        a crash between rotate and publish recovers from the previous
        snapshot plus BOTH segments, losing nothing. Without this split,
        commits folded while the snapshot file was being written would
        sit in a segment the truncation then deletes — ACKed work
        silently lost."""
        self.open_segment(int(version))
        self.commits_since_snapshot = 0

    def publish_snapshot(self, state: dict) -> None:
        """Phase 2 — runs OUTSIDE the center lock (O(model) serialize +
        fsync must not stall the fold path): durably write ``state`` at
        its ``num_updates`` version (tmp + fsync + atomic rename), then
        delete snapshots and segments strictly below it. Only after the
        rename is the old history unreferenced."""
        version = int(state["num_updates"])
        path = os.path.join(
            self.dir, f"{_SNAP_PREFIX}{version:012d}{_SNAP_SUFFIX}"
        )
        tmp = path + f".tmp.{os.getpid()}"
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        with open(tmp, "wb") as f:
            f.write(struct.pack(">I", zlib.crc32(blob)))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        self.bytes_written += 4 + len(blob)
        os.replace(tmp, path)
        for name in os.listdir(self.dir):
            base = None
            if name.startswith(_SNAP_PREFIX) and name.endswith(_SNAP_SUFFIX):
                base = name[len(_SNAP_PREFIX):-len(_SNAP_SUFFIX)]
            elif name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
                base = name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
            if base is None or not base.isdigit() or int(base) >= version:
                continue
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    def _close_segment(self) -> None:
        """Drain+fsync+close the live segment (rotation path — the flusher
        keeps running). Queued records belong to THIS segment, so the
        drain must complete under ``_io_lock`` before the file swaps;
        publishing durability releases deferred ACKs riding it."""
        if self._fh is None:
            return
        with self._io_lock:
            fh = self._fh
            if fh is None:
                return
            self._write_queue_io_locked()
            try:
                fh.close()
            except (OSError, ValueError):
                pass
            self._fh = None

    def close(self) -> None:
        """Clean shutdown: stop the flusher, fsync the tail, close."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._flusher.is_alive() \
                and self._flusher is not threading.current_thread():
            self._flusher.join(timeout=5.0)
        self._close_segment()

    def abandon(self) -> None:
        """Crash seam: die like a SIGKILL'd process. The underlying fd is
        closed WITHOUT flushing the user-space buffer (whatever earlier
        flushes handed the OS is durable, buffered bytes are lost — and
        their commits were never ACKed, so their clients replay them) and
        every deferred-ACK waiter is woken to give up."""
        with self._cond:
            self._abandoned = True
            self._running = False
            self._queue = []  # the lost user-space buffer
            self._cond.notify_all()
        with self._io_lock:  # let an in-flight flusher write land first
            fh, self._fh = self._fh, None
            if fh is not None:
                try:
                    # repoint the descriptor at /dev/null BEFORE closing:
                    # anything still buffered in the file object (the
                    # dying process's user-space bytes) is discarded, and
                    # the close itself stays safe — a raw os.close here
                    # would leave the object's finalizer closing a
                    # recycled fd number out from under its new owner
                    null_fd = os.open(os.devnull, os.O_WRONLY)
                    try:
                        os.dup2(null_fd, fh.fileno())
                    finally:
                        os.close(null_fd)
                    fh.close()
                except (OSError, ValueError):
                    pass


# -- state <-> snapshot ------------------------------------------------------


def ps_state_dict(center: Pytree, num_updates: int,
                  pull_versions: dict, last_seq: dict,
                  ema: Pytree | None, ema_version: int,
                  fence_epoch: int,
                  prev_pull_versions: dict | None = None) -> dict:
    """The full recoverable PS state (plain containers + numpy only, so
    the restricted unpickler can load it back). ``prev_pull_versions``
    is each worker's previous recorded pull version — the base
    a pipelined fused exchange prices its deliberately-stale commit from;
    old snapshots without the key recover with an empty map and the next
    pull record per worker rebuilds it exactly (the shift rule below)."""
    return {
        "center": center,
        "num_updates": int(num_updates),
        "pull_versions": dict(pull_versions),
        "prev_pull_versions": dict(prev_pull_versions or {}),
        "last_seq": dict(last_seq),
        "ema": ema,
        "ema_version": int(ema_version),
        "fence_epoch": int(fence_epoch),
    }


def _load_snapshot(path: str) -> dict | None:
    try:
        with open(path, "rb") as f:
            data = f.read()
        (crc,) = struct.unpack_from(">I", data, 0)
        blob = data[4:]
        if zlib.crc32(blob) != crc:
            return None
        return _restricted_loads(blob)
    except Exception:
        return None


def replay_record(state: dict, rec_type: int, body: Any, rule,
                  num_workers: int, ema_decay: float | None) -> None:
    """Apply ONE record to ``state`` (the dict ``ps_state_dict`` shapes).

    This is the single definition of "apply an event": crash recovery
    replays disk records through it and the hot standby applies streamed
    records through it — the two consumers cannot diverge. The fold and
    EMA arithmetic are the PS's own (the same ``rule.fold`` →
    ``tree_to_numpy`` → fma sequence), so a replayed state is
    bit-identical to the sequential no-crash server's.
    """
    from distkeras_tpu_torch import utils

    if rec_type in (REC_COMMIT, REC_COMMIT2, REC_COMMIT_WIRE):
        worker_id, seq, pull_version, version, payload_bytes = body
        if version != state["num_updates"] + 1:
            raise ValueError(
                f"WAL sequence gap: record folds to version {version} but "
                f"state is at {state['num_updates']} (segments replayed out "
                f"of order, or mixed logs in one directory)"
            )
        if "_flat" in state:
            # a pickle commit following native flat records (transport
            # switch mid-log): materialize the flat folds into the tree
            # before tree-folding on top of them
            _finish_flat_replay(state)
        # no dup-skip needed here: only DEDUPLICATED folds are ever logged
        # or streamed, so every COMMIT record is a real, distinct fold
        payload = _restricted_loads(payload_bytes)
        if rec_type == REC_COMMIT_WIRE:
            # the logged bytes are the whole wire request frame: re-run
            # the live commit path's exact decode pipeline, so the fold
            # input (and therefore the folded center) is bit-identical
            from distkeras_tpu_torch.parallel.compression import maybe_decode

            payload = utils.tree_to_numpy(maybe_decode(payload["payload"]))
        staleness = state["num_updates"] - pull_version
        state["center"] = utils.tree_to_numpy(
            rule.fold(state["center"], payload, num_workers, staleness)
        )
        state["num_updates"] += 1
        if seq is not None:
            state["last_seq"][worker_id] = seq
        if ema_decay is not None and state.get("ema") is not None \
                and state["num_updates"] > state["ema_version"]:
            # a snapshot's EMA may run AHEAD of its center version (the
            # EMA folds on its own lock after the commit's critical
            # section): folds at or below ema_version are already in it
            _ema_fma_inplace(state["ema"], state["center"], ema_decay)
            state["ema_version"] = state["num_updates"]
    elif rec_type == REC_COMMIT_FLAT:
        # native commit: the C++ fold was `center[i] += payload[i] * scale`
        # (one mul, one add per element, no FMA contraction on baseline
        # x86-64) on a flat f32 vector — replay runs the SAME saxpy on a
        # flat view of the state, so the recovered center is bit-identical
        # to the native server's. The record is self-contained (the fold
        # scale rides it), so replay needs no merge-rule arithmetic.
        worker_id, seq, pull_version, version, scale, payload = body
        if version != state["num_updates"] + 1:
            raise ValueError(
                f"WAL sequence gap: native record folds to version "
                f"{version} but state is at {state['num_updates']}"
            )
        flat = _flat_replay_state(state)
        if payload.shape[0] != flat["c"].shape[0]:
            raise ValueError(
                f"native WAL record carries {payload.shape[0]} floats but "
                f"the center holds {flat['c'].shape[0]}"
            )
        flat["c"] += payload * scale
        state["num_updates"] += 1
        if seq is not None:
            state["last_seq"][worker_id] = seq
        if ema_decay is not None and flat["e"] is not None:
            # dkps.cpp: e[i] = d*e[i] + (1.0f - d)*c[i] with d cast to f32:
            # the f32 `1 - d`, not the f64 one rounded later
            d32 = np.float32(ema_decay)
            od32 = np.float32(1.0) - d32
            flat["e"] *= d32
            flat["e"] += flat["c"] * od32
            state["ema_version"] = state["num_updates"]
    elif rec_type in (REC_PULL, REC_PULL_FLAT):
        worker_id, version = body
        # the live servers shift cur → prev on EVERY pull-version record
        # (plain pull or fused exchange); replay runs the identical rule,
        # so a recovered pipelined worker's lag pricing is bit-exact
        prev = state["pull_versions"].get(worker_id)
        if prev is not None:
            state.setdefault("prev_pull_versions", {})[worker_id] = prev
        state["pull_versions"][worker_id] = version
    elif rec_type in (REC_DEREG, REC_DEREG_FLAT):
        (worker_id,) = body
        state["last_seq"].pop(worker_id, None)
        # pull-version slots retire with the clean exit (the live
        # servers' deregister rule — see ParameterServer.deregister_worker)
        state["pull_versions"].pop(worker_id, None)
        state.get("prev_pull_versions", {}).pop(worker_id, None)
    elif rec_type in (REC_EVICT, REC_EVICT_FLAT):
        (worker_ids,) = body
        for wid in worker_ids:
            state["pull_versions"].pop(wid, None)
            state.get("prev_pull_versions", {}).pop(wid, None)
            state["last_seq"].pop(wid, None)
    elif rec_type in (REC_FENCE, REC_FENCE_FLAT):
        (epoch,) = body
        state["fence_epoch"] = max(state["fence_epoch"], epoch)
    elif rec_type == REC_EPOCH:
        # advisory training-epoch mark: stored OUTSIDE ps_state_dict's
        # fixed shape (lazily, only when present) so snapshots from
        # before the record type existed round-trip byte-identically
        (epoch,) = body
        state["epoch_mark"] = max(int(state.get("epoch_mark", -1)),
                                  int(epoch))
    # unknown types: forward-compat skip


def _flat_replay_state(state: dict) -> dict:
    """Lazy flat f32 view of the state for native-record replay: the
    center (and EMA) are flattened once on the first flat record and
    written back by :func:`_finish_flat_replay`. Mixing flat records into
    a log whose pickle commits already advanced the tree would desync the
    two views — one server type per directory, enforced here."""
    flat = state.get("_flat")
    if flat is None:
        from distkeras_tpu_torch.native_ps import FlatSpec

        spec = FlatSpec(state["center"])
        flat = {"spec": spec, "c": spec.flatten(state["center"]),
                "e": (spec.flatten(state["ema"])
                      if state.get("ema") is not None else None)}
        state["_flat"] = flat
    return flat


def _finish_flat_replay(state: dict) -> None:
    flat = state.pop("_flat", None)
    if flat is None:
        return
    state["center"] = flat["spec"].unflatten(flat["c"])
    if flat["e"] is not None:
        state["ema"] = flat["spec"].unflatten(flat["e"])


def _ema_fma_inplace(ema: Pytree, center: Pytree, d: float) -> None:
    """``e = d·e + (1−d)·c`` in the Python PS's operation order (multiply
    into a temporary, scale e, add), so replay matches the live fold
    bitwise."""
    from distkeras_tpu_torch import utils

    def fma(e, c):
        s = np.multiply(np.asarray(c, dtype=e.dtype), 1.0 - d)
        e *= d
        e += s

    utils.host_tree_map(fma, ema, center)


def recover_ps_state(directory: str, rule, num_workers: int,
                     ema_decay: float | None,
                     template: Pytree | None = None) -> dict | None:
    """Reconstruct the PS state from ``(newest valid snapshot, wal)``.

    Returns the state dict (plus ``state["replayed"]`` = records applied
    after the snapshot) or None when the directory holds no durable state
    (fresh start). A snapshot that fails its CRC falls back to the next
    older one; WAL segments BELOW the chosen snapshot version are ignored
    (already folded into it), the segment AT it is replayed to its
    durable prefix.
    """
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    snaps = sorted(
        (n for n in names
         if n.startswith(_SNAP_PREFIX) and n.endswith(_SNAP_SUFFIX)),
        reverse=True,
    )
    segs = sorted(
        n for n in names
        if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)
    )
    state = None
    snap_version = 0
    for name in snaps:
        state = _load_snapshot(os.path.join(directory, name))
        if state is not None:
            snap_version = int(state["num_updates"])
            break
    if state is None:
        if not segs:
            return None
        if template is None:
            raise ValueError(
                f"WAL at {directory} has segments but no snapshot and no "
                f"template center to replay onto"
            )
        from distkeras_tpu_torch import utils

        state = ps_state_dict(
            utils.tree_to_numpy(template), 0, {}, {},
            None, 0, 0,
        )
        if ema_decay is not None:
            state["ema"] = utils.host_tree_map(np.copy, state["center"])
    replayed = 0
    for name in segs:
        base = int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
        if base < snap_version:
            continue  # pre-snapshot history, already folded in
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        for rec_type, body in iter_records(data):
            replay_record(state, rec_type, body, rule, num_workers, ema_decay)
            replayed += 1
    _finish_flat_replay(state)  # native flat folds back into the tree
    state["replayed"] = replayed
    return state


# -- offline inspection (`python -m distkeras_tpu_torch.resilience.wal verify`)


_REC_NAMES = {
    REC_COMMIT: "commit", REC_COMMIT2: "commit", REC_COMMIT_FLAT: "commit",
    REC_COMMIT_WIRE: "commit",
    REC_PULL: "pull", REC_PULL_FLAT: "pull",
    REC_DEREG: "dereg", REC_DEREG_FLAT: "dereg",
    REC_EVICT: "evict", REC_EVICT_FLAT: "evict",
    REC_FENCE: "fence", REC_FENCE_FLAT: "fence",
    REC_DIR_PUT: "dir_put", REC_DIR_DEL: "dir_del",
    REC_DIR_EXPIRE: "dir_expire", REC_DIR_FENCE: "dir_fence",
    REC_EPOCH: "epoch",
}

#: record-name prefix marking a membership-directory log — ``verify``
#: flags such directories so an operator reading the aggregate report
#: can tell the coordination log from the per-shard commit logs
_DIR_REC_PREFIX = "dir_"


def verify_dir(directory: str) -> dict:
    """Walk a WAL directory's ``(snapshot, wal)`` files and report their
    health — CRC-valid prefix length, torn-tail bytes, and record-type
    counts per segment, snapshot CRC validity — WITHOUT replaying any
    state (no rule/model needed; cheap enough for CI artifacts). The
    chaos tests use this instead of ad-hoc segment parsing."""
    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        return {"dir": str(directory), "ok": False, "error": str(e),
                "snapshots": [], "segments": []}
    report: dict = {"dir": str(directory), "ok": True,
                    "snapshots": [], "segments": []}
    totals: dict[str, int] = {}
    for name in names:
        path = os.path.join(directory, name)
        if name.startswith(_SNAP_PREFIX) and name.endswith(_SNAP_SUFFIX):
            state = _load_snapshot(path)
            rec = {
                "file": name,
                "bytes": os.path.getsize(path),
                "crc_ok": state is not None,
                "version": (None if state is None
                            else int(state["num_updates"])),
            }
            report["snapshots"].append(rec)
            if state is None:
                report["ok"] = False
        elif name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
            with open(path, "rb") as f:
                data = f.read()
            good = durable_prefix_len(data)
            counts: dict[str, int] = {}
            for rec_type, _ in iter_records(data):
                key = _REC_NAMES.get(rec_type, f"type{rec_type}")
                counts[key] = counts.get(key, 0) + 1
                totals[key] = totals.get(key, 0) + 1
            rec = {
                "file": name,
                "base": int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]),
                "bytes": len(data),
                "valid_prefix_bytes": good,
                "torn_tail_bytes": len(data) - good,
                "records": counts,
            }
            report["segments"].append(rec)
    report["record_totals"] = totals
    # a membership-directory log (directory/service.py) walks the same
    # framing; flag it so the aggregate report names which directory under
    # a shared root is the coordination log vs a shard's commit log
    report["directory"] = any(
        k.startswith(_DIR_REC_PREFIX) for k in totals
    )
    report["torn_tail_bytes"] = sum(
        s["torn_tail_bytes"] for s in report["segments"]
    )
    # a torn tail on the LIVE (newest) segment is expected after a crash;
    # a snapshot that fails its CRC, or a torn NON-live segment, is not
    for s in report["segments"][:-1]:
        if s["torn_tail_bytes"]:
            report["ok"] = False
    return report


def _holds_wal_files(directory: str) -> bool:
    try:
        names = os.listdir(directory)
    except OSError:
        return False
    return any(
        (n.startswith(_SNAP_PREFIX) and n.endswith(_SNAP_SUFFIX))
        or (n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX))
        for n in names
    )


def find_wal_dirs(root: str) -> list[str]:
    """Every directory under ``root`` (inclusive) holding WAL/snapshot
    files, sorted — a sharded center's root fans out into per-shard
    subdirectories (``shard-00``, …) each possibly with chain-replica
    subdirectories (``chain-1``, …); see ``sharding.group``."""
    out = []
    for dirpath, dirnames, _ in os.walk(root):
        dirnames.sort()
        if _holds_wal_files(dirpath):
            out.append(dirpath)
    return sorted(out)


def verify_tree(root: str) -> dict:
    """Verify a WAL location that may be a single directory OR a sharded
    root (per-shard subdirectories, each verified like any other WAL dir,
    rolled into ONE aggregate report — the shape the chaos tests and the
    CI artifact consume). A plain directory returns ``verify_dir``'s
    report unchanged."""
    dirs = find_wal_dirs(root)
    if dirs == [root] or not dirs:
        return verify_dir(root)
    reports = []
    totals: dict[str, int] = {}
    ok = True
    for d in dirs:
        rep = verify_dir(d)
        rep["dir"] = os.path.relpath(d, root)
        reports.append(rep)
        ok = ok and rep["ok"]
        for key, n in rep.get("record_totals", {}).items():
            totals[key] = totals.get(key, 0) + n
    return {
        "dir": str(root),
        "sharded": True,
        "ok": ok,
        "dirs": reports,
        "num_wal_dirs": len(reports),
        "num_directory_dirs": sum(
            1 for r in reports if r.get("directory")
        ),
        "record_totals": totals,
        "torn_tail_bytes": sum(r["torn_tail_bytes"] for r in reports),
    }


def main(argv: list[str] | None = None) -> int:
    """CLI: ``python -m distkeras_tpu_torch.resilience.wal verify <dir>``.

    ``<dir>`` may be one server's WAL directory or a sharded root — the
    latter prints one aggregate report over every shard (and chain
    replica) directory beneath it.
    """
    import json
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2 or argv[0] != "verify":
        print("usage: python -m distkeras_tpu_torch.resilience.wal verify "
              "<dir>",
              file=sys.stderr)
        return 2
    report = verify_tree(argv[1])
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover - exercised via main()
    raise SystemExit(main())
