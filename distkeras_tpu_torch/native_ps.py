"""The native parameter server (``ps_transport="native"``): a C++ TCP
service, a flat f32 wire, a fold without the GIL.

Port of ``distkeras_tpu/native_ps.py``. The socket PS pickles the whole
tree each way and folds in Python handler threads that hold the GIL; here
the wire path is the C++ core in ``native/dkps.cpp``: weights travel as
one contiguous f32 vector (no pickle; the frame size is pinned at the
handshake), a commit folds as ``center += scale · commit`` under a C++
mutex, and every ``ctypes`` call releases the GIL, so worker threads pull
and commit at once.

The fold is the linear form every built-in ``MergeRule.fold`` defines:
ADAG scales a commit by ``1/num_workers``, DOWNPOUR and the elastic rules
by 1, DynSGD by ``1/(τ+1)`` with τ tracked per worker in the server (and
priced from the previous pull for an exchange that carries ``lag``). A
custom rule with another fold is refused: it needs
``ps_transport="socket"``.

A tree crosses the boundary through :class:`FlatSpec`: leaves raveled in C
order into one f32 vector, in :func:`utils.flatten`'s order (dict keys
sorted, as ``jax.tree`` walks them), so the vector is the JAX package's
and either package's client works against the other's server.

The resilience layer is the C++ core's: per-worker seqno dedup
(``COMMIT_SEQ``), fencing (``COMMIT_SEQ_E``, ``FENCE``), leases
(``HEARTBEAT``, ``DEREGISTER``) and a group-commit write-ahead log in the
Python PS's record format (flat f32 records). Recovery is this side's
job: a server built with ``wal_dir`` replays ``(snapshot, wal)`` through
the port's ``resilience.wal.recover_ps_state``, installs the state in the
C++ server and publishes a fresh base snapshot before handing the live
segment to the C++ appender. The center's EMA is ``ROADMAP.md`` A8 and
raises naming it.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import time
from typing import Any

import numpy as np

from distkeras_tpu_torch import networking, utils
from distkeras_tpu_torch.native import load_dkps
from distkeras_tpu_torch.parallel.compression import (
    _MARK,
    is_encoded,
    validate_pull_compression,
)
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
)
from distkeras_tpu_torch.parameter_servers import (
    _encoded_as_leaves,
    build_ps_stats,
)

Tree = Any

_MODE_FIXED = 0
_MODE_INV_STALENESS = 1

#: EXCHANGE flags (dkps.cpp, action 14): bit 0 a seq, bit 1 an epoch,
#: bit 2 an int8 reply, bit 3 lag
_XCHG_SEQ = 1
_XCHG_EPOCH = 2
_XCHG_INT8 = 4
_XCHG_LAG = 8


def fold_mode(rule: MergeRule, num_workers: int) -> tuple[int, float]:
    """A built-in merge rule as the server's ``(mode, fixed_scale)``:
    ADAG ``c + d/W``; DOWNPOUR and the elastic rules ``c + d``; DynSGD
    ``c + d/(τ+1)``."""
    if isinstance(rule, DynSGDMerge):
        return _MODE_INV_STALENESS, 1.0
    if isinstance(rule, ADAGMerge):
        return _MODE_FIXED, 1.0 / float(num_workers)
    if isinstance(rule, (DownpourMerge, ElasticAverageMerge)):
        return _MODE_FIXED, 1.0
    raise ValueError(
        f"ps_transport='native' supports the built-in linear merge rules "
        f"(ADAG/DOWNPOUR/elastic/DynSGD); {type(rule).__name__} defines an "
        f"arbitrary fold — use ps_transport='socket'")


class FlatSpec:
    """The shapes and dtypes that turn a host tree into one f32 vector and
    back."""

    def __init__(self, template: Tree):
        leaves, self.structure = utils.flatten(template)
        self.shapes = [np.shape(leaf) for leaf in leaves]
        self.dtypes = [np.asarray(leaf).dtype for leaf in leaves]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.n = int(sum(self.sizes))

    def flatten(self, tree: Tree) -> np.ndarray:
        leaves = utils.flatten(tree)[0]
        if len(leaves) != len(self.sizes):
            raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                             f"{len(self.sizes)}")
        out = np.empty(self.n, dtype=np.float32)
        off = 0
        for leaf, size in zip(leaves, self.sizes):
            out[off:off + size] = np.ravel(np.asarray(leaf, np.float32),
                                           order="C")
            off += size
        return out

    def unflatten(self, vec: np.ndarray) -> Tree:
        leaves = []
        off = 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(vec[off:off + size].reshape(shape)
                          .astype(dtype, copy=False))
            off += size
        return utils.unflatten(self.structure, leaves)


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeSocketParameterServer:
    """The C++ TCP parameter server with ``SocketParameterServer``'s
    surface: ``initialize()`` binds (resolving an ephemeral port) and,
    with ``wal_dir``, recovers the directory's state and opens the C++
    WAL; ``start()`` runs the C++ accept loop, ``stop()`` shuts it down
    and joins every handler, ``crash()`` dies like a killed process;
    ``get_model()``, ``num_updates`` and ``fence_epoch`` read the server
    under its C++ mutex."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 host: str = "127.0.0.1", port: int = 0,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, snapshot_every: int = 100,
                 fence_epoch: int = 0, wal_group_window: int = 8,
                 wal_group_interval: float = 0.25):
        if ema_decay is not None:
            raise NotImplementedError(
                "the native PS's center EMA is not ported yet: ROADMAP.md "
                "A8 (checkpoints and EMA)")
        if lease_timeout is not None and lease_timeout <= 0:
            raise ValueError(
                f"lease_timeout must be positive, got {lease_timeout}")
        self._lib = load_dkps()
        self.spec = FlatSpec(center)
        self.rule = rule
        self.num_workers = int(num_workers)
        self.host = host
        self.port = int(port)
        self.lease_timeout = lease_timeout
        self.wal_dir = None if wal_dir is None else str(wal_dir)
        self.snapshot_every = int(snapshot_every)
        self.wal_group_window = int(wal_group_window)
        self.wal_group_interval = float(wal_group_interval)
        self._requested_fence_epoch = int(fence_epoch)
        self.recovered_ = False
        self.wal_replay_s = 0.0
        self.crashed_ = False
        self._handle = None
        self._init_vec = self.spec.flatten(center)

    def initialize(self) -> None:
        state = self._recover_wal_state()
        mode, scale = fold_mode(self.rule, self.num_workers)
        init_vec = self._init_vec
        if state is not None:
            init_vec = np.ascontiguousarray(
                self.spec.flatten(state["center"]))
        h = self._lib.dkps_server_create(
            _f32p(init_vec), self.spec.n, mode, scale,
            self.host.encode(), self.port, -1.0,
            -1.0 if self.lease_timeout is None else self.lease_timeout)
        if not h:
            raise OSError(f"dkps server failed to bind {self.host}:"
                          f"{self.port}")
        self._handle = h
        self.port = int(self._lib.dkps_server_port(h))
        fence = self._requested_fence_epoch
        if state is not None:
            self._restore_state(state)
            fence = max(fence, int(state["fence_epoch"]))
        if fence:
            self._lib.dkps_server_fence(h, fence)
        # the pool gauge of stats(), as the Python PS reports it
        self._lib.dkps_server_set_pool_size(h, self.num_workers)
        if self.wal_dir is not None:
            self._attach_wal(state)
        self._t_start = time.monotonic()

    # -- durability: recovery is this side's, appending the C++ core's --------

    def _recover_wal_state(self) -> dict | None:
        if self.wal_dir is None:
            return None
        from distkeras_tpu_torch.resilience.wal import recover_ps_state

        t0 = time.monotonic()
        state = recover_ps_state(self.wal_dir, self.rule, self.num_workers,
                                 None,
                                 template=self.spec.unflatten(self._init_vec))
        if state is not None:
            self.recovered_ = True
            self.wal_replay_s = time.monotonic() - t0
        return state

    def _restore_state(self, state: dict) -> None:
        """Install the replayed state in the C++ server: the update count
        and each worker's dedup seqno and pull versions (the exactly-once
        fence and DynSGD's staleness bases)."""
        self._lib.dkps_server_set_num_updates(self._handle,
                                              int(state["num_updates"]))
        prev = state.get("prev_pull_versions", {})
        for wid in (set(state["pull_versions"]) | set(state["last_seq"])
                    | set(prev)):
            self._lib.dkps_server_restore_worker(
                self._handle, int(wid),
                int(state["last_seq"].get(wid, -1)),
                int(state["pull_versions"].get(wid, -1)),
                int(prev.get(wid, -1)))

    def _attach_wal(self, state: dict | None) -> None:
        """Publish a base snapshot at the (possibly recovered) version,
        which truncates the history below it, through the same
        ``CommitLog`` the Python PS writes with, then hand the live segment
        to the C++ appender: a native log replays through
        ``recover_ps_state`` like any other."""
        from distkeras_tpu_torch.resilience import wal as _wal

        version = self.num_updates
        if state is not None:
            snap_state = dict(state)
            snap_state.pop("replayed", None)
        else:
            snap_state = _wal.ps_state_dict(
                self.spec.unflatten(self._init_vec), 0, {}, {}, None, 0,
                self.fence_epoch)
        snap_state["fence_epoch"] = max(
            int(snap_state.get("fence_epoch", 0)), self.fence_epoch)
        log = _wal.CommitLog(self.wal_dir,
                             snapshot_every=self.snapshot_every)
        try:
            # rotate, then publish: the live segment is opened (and its
            # torn tail truncated) before the publish drops older history
            log.rotate(version)
            log.publish_snapshot(snap_state)
        finally:
            log.close()
        seg_path = os.path.join(
            self.wal_dir,
            f"{_wal._SEG_PREFIX}{version:012d}{_wal._SEG_SUFFIX}")
        rc = self._lib.dkps_server_wal_open(
            self._handle, seg_path.encode(), max(0, self.wal_group_window),
            self.wal_group_interval)
        if rc != 0:
            raise OSError(f"dkps could not open WAL segment {seg_path}")

    def crash(self) -> None:
        """Chaos seam: die like a killed process: connections torn, the
        WAL abandoned with its unflushed window, no final fsync."""
        if self._handle is not None:
            self._lib.dkps_server_crash(self._handle)
        self.crashed_ = True

    def start(self) -> None:
        self._lib.dkps_server_start(self._handle)

    def stop(self) -> None:
        if self._handle is not None:
            self._lib.dkps_server_stop(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.dkps_server_destroy(self._handle)
            self._handle = None

    # -- the center -----------------------------------------------------------

    @property
    def num_updates(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.dkps_server_num_updates(self._handle))

    def get_model(self) -> Tree:
        out = np.empty(self.spec.n, dtype=np.float32)
        self._lib.dkps_server_get_center(self._handle, _f32p(out))
        return self.spec.unflatten(out)

    # -- fencing --------------------------------------------------------------

    @property
    def fence_epoch(self) -> int:
        if self._handle is None:
            return self._requested_fence_epoch
        return int(self._lib.dkps_server_fence_epoch(self._handle))

    def fence(self, epoch: int) -> int:
        """Raise the fencing epoch (monotone; durable before it returns
        with a WAL); returns the epoch after."""
        return int(self._lib.dkps_server_fence(self._handle, int(epoch)))

    # -- the C++ span ring ----------------------------------------------------

    #: span kinds of the C++ ring (dkps.cpp ``TK_*``), in the Python
    #: server's ``ps.*`` names
    _TRACE_KINDS = {1: "ps.fold", 2: "ps.wal_wait", 3: "wal.fsync"}

    def set_trace(self, on: bool) -> None:
        """Arm (or disarm) the server's span ring: fold sections,
        deferred-ACK WAL waits and group fsyncs (monotonic ns)."""
        self._lib.dkps_server_set_trace(self._handle, 1 if on else 0)

    def scrape_trace_events(self, max_records: int = 8192) -> list[dict]:
        """Drain the span ring over the wire (TRACE, action 15): one dict a
        span, ``{"name", "worker", "seq", "t0_ns", "dur_ns"}`` (``worker``
        None for the flusher's fsyncs)."""
        client = NativePSClient("127.0.0.1", self.port, 2**32 - 2, self.spec)
        try:
            buf = (ctypes.c_uint64 * (5 * max_records))()
            n = int(self._lib.dkps_client_trace_scrape(client._handle, buf,
                                                       max_records))
        finally:
            client.close()
        if n < 0:
            raise ConnectionError("dkps trace scrape failed")
        out = []
        for i in range(n):
            kind, wid, seq, t0, dur = buf[5 * i:5 * i + 5]
            out.append({"name": self._TRACE_KINDS.get(kind, f"ps.kind{kind}"),
                        "worker": None if wid == 0xFFFFFFFF else int(wid),
                        "seq": int(seq), "t0_ns": int(t0),
                        "dur_ns": int(dur)})
        return out

    def stats(self) -> dict:
        """``ParameterServer.stats()``'s keys and derived values
        (``build_ps_stats``), from the C++ server's counters: operations,
        payload bytes, the center mutex's wait and hold, and the dedup,
        fencing, lease and WAL counters."""
        raw = (ctypes.c_uint64 * 22)()
        self._lib.dkps_server_stats(self._handle, raw)
        (pulls, cpulls, commits, bytes_in, bytes_out, acq, wait, hold,
         dups, active, evicted, heartbeats, retries, fenced, wal_records,
         wal_fsyncs, wal_group_max, pool, joined, preempted, drain_to,
         fused) = (int(v) for v in raw)
        return build_ps_stats(
            pulls, cpulls, commits, bytes_in, bytes_out, acq, wait, hold,
            time.monotonic() - self._t_start, dup_commits=dups,
            active_workers=active, evicted_workers=evicted,
            heartbeats=heartbeats, worker_retries=retries,
            fenced_commits=fenced, num_updates=self.num_updates,
            wal_records=wal_records, wal_fsyncs=wal_fsyncs,
            wal_group_max=wal_group_max, pool_size=pool,
            joined_workers=joined, preempted_workers=preempted,
            drain_timeouts=drain_to, fused_exchanges=fused)


class NativePSClient:
    """The worker's proxy over the C interface, with
    ``ParameterServerClient``'s surface; the GIL is released for each whole
    round trip."""

    def __init__(self, host: str, port: int, worker_id: int, spec: FlatSpec,
                 connect_timeout: float = 30.0,
                 pull_compression: str | None = None,
                 epoch: int | None = None):
        # the fencing token: commits with a seq AND an epoch ride
        # COMMIT_SEQ_E (action 10); None is never fenced
        self.epoch = None if epoch is None else int(epoch)
        self.pull_compression = validate_pull_compression(pull_compression)
        self._lib = load_dkps()
        self.worker_id = int(worker_id)
        self.spec = spec
        # Python opens the connection (names, IPv6, the connect timeout);
        # C adopts the descriptor for the framing. The descriptor goes back
        # to blocking mode first (a connect timeout leaves O_NONBLOCK set),
        # with SO_RCVTIMEO bounding the handshake (it survives the handover)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=connect_timeout)
        except OSError as e:
            raise ConnectionError(
                f"dkps client could not connect to {host}:{port}: {e}") \
                from e
        sock.settimeout(None)
        tv = struct.pack("ll", max(1, int(connect_timeout)), 0)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        self._handle = self._lib.dkps_client_from_fd(
            sock.detach(), self.worker_id, spec.n)
        if not self._handle:
            raise ConnectionError(
                f"dkps handshake with {host}:{port} failed (is it a dkps "
                f"server, and does its vector length match {spec.n}?)")
        # round trips block by default, as ParameterServerClient's do
        self.set_timeout(None)

    def pull(self, worker_id: int | None = None) -> Tree:
        out = np.empty(self.spec.n, dtype=np.float32)
        if self.pull_compression == "int8":
            # the compressed pull: about n payload bytes instead of 4n; the
            # server keeps this worker's quantisation residual
            version = self._lib.dkps_client_pull_int8(self._handle,
                                                      _f32p(out))
        else:
            version = self._lib.dkps_client_pull(self._handle, _f32p(out))
        if version < 0:
            raise ConnectionError("dkps pull failed (server gone?)")
        return self.spec.unflatten(out)

    def commit(self, worker_id: int | None, payload: Tree,
               seq: int | None = None) -> None:
        """``seq``: the per-worker seqno the server folds at most once
        (``COMMIT_SEQ``, or ``COMMIT_SEQ_E`` with the fencing epoch; a
        duplicate's ack is success). The segmented int8 wire has no seq
        slot."""
        if is_encoded(payload):
            if seq is not None:
                raise ValueError(
                    "ps_transport='native' carries commit seqnos on the raw "
                    "f32 wire only; use ps_transport='socket' to combine "
                    "compression with retries")
            return self._commit_int8(payload)
        vec = np.ascontiguousarray(self.spec.flatten(payload))
        if seq is not None and self.epoch is not None:
            sepoch = ctypes.c_uint64(0)
            rc = self._lib.dkps_client_commit_seq_e(
                self._handle, int(self.epoch), int(seq), _f32p(vec),
                ctypes.byref(sepoch))
            if rc < 0:
                raise ConnectionError("dkps commit failed (server gone?)")
            if rc == 2:
                raise networking.FencedEpochError(
                    "commit fenced by the native server",
                    client_epoch=self.epoch, server_epoch=int(sepoch.value))
            return
        if seq is not None:
            rc = self._lib.dkps_client_commit_seq(self._handle, int(seq),
                                                  _f32p(vec))
        else:
            rc = self._lib.dkps_client_commit(self._handle, _f32p(vec))
        if rc < 0 or (seq is None and rc != 0):
            raise ConnectionError("dkps commit failed (server gone?)")

    def exchange(self, worker_id: int | None, payload: Tree,
                 seq: int | None = None, lag: bool = False) -> Tree:
        """Fused commit + pull (EXCHANGE, action 14): one round trip folds
        ``payload`` and returns the post-fold center, on the compressed
        pull wire when ``pull_compression='int8'``; ``lag=True`` prices τ
        from this worker's previous pull. ``seq`` and the client's epoch
        ride the frame as in ``commit``. A codec-encoded commit has no
        fused frame: it takes the two-trip commit and pull."""
        if is_encoded(payload):
            self.commit(worker_id, payload, seq=seq)
            return self.pull()
        vec = np.ascontiguousarray(self.spec.flatten(payload))
        out = np.empty(self.spec.n, dtype=np.float32)
        flags = ((_XCHG_SEQ if seq is not None else 0)
                 | (_XCHG_EPOCH if self.epoch is not None else 0)
                 | (_XCHG_INT8 if self.pull_compression == "int8" else 0)
                 | (_XCHG_LAG if lag else 0))
        sepoch = ctypes.c_uint64(0)
        rc = self._lib.dkps_client_exchange(
            self._handle, flags, 0 if self.epoch is None else self.epoch,
            0 if seq is None else int(seq), _f32p(vec), _f32p(out),
            ctypes.byref(sepoch))
        if rc == -2:
            raise networking.FencedEpochError(
                "exchange fenced by the native server",
                client_epoch=self.epoch, server_epoch=int(sepoch.value))
        if rc < 0:
            raise ConnectionError("dkps exchange failed (server gone?)")
        return self.spec.unflatten(out)

    def heartbeat(self, retries: int = 0) -> bool:
        """Renew this worker's lease (HEARTBEAT, action 6); True when the
        lease already existed."""
        rc = self._lib.dkps_client_heartbeat(self._handle, int(retries))
        if rc < 0:
            raise ConnectionError("dkps heartbeat failed (server gone?)")
        return rc == 1

    def deregister(self) -> None:
        """A clean exit: drop this worker's lease without an eviction."""
        if self._lib.dkps_client_deregister(self._handle) != 0:
            raise ConnectionError("dkps deregister failed (server gone?)")

    def fence(self, epoch: int) -> int:
        """Raise the server's fencing epoch (FENCE, action 9); returns the
        epoch after."""
        rc = int(self._lib.dkps_client_fence(self._handle, int(epoch)))
        if rc < 0:
            raise ConnectionError("dkps fence failed (server gone?)")
        return rc

    def _commit_int8(self, blob: dict) -> None:
        """An ``Int8Codec`` blob on the segmented int8 wire (action 4): 4×
        fewer payload bytes; the C++ fold dequantises each segment with its
        leaf's scale, so the center sees exactly the tree
        ``Int8Codec.decode`` gives."""
        if blob[_MARK] != "int8":
            raise ValueError(
                f"ps_transport='native' carries compression='int8' only; got "
                f"codec {blob[_MARK]!r} (use ps_transport='socket')")
        leaves = utils.flatten(_encoded_as_leaves(blob["tree"]))[0]
        if len(leaves) != len(self.spec.sizes):
            raise ValueError(f"blob has {len(leaves)} leaves, spec expects "
                             f"{len(self.spec.sizes)}")
        qv = np.empty(self.spec.n, np.int8)
        scales = np.empty(len(leaves), np.float32)
        off = 0
        for i, (leaf, size) in enumerate(zip(leaves, self.spec.sizes)):
            leaf = getattr(leaf, "leaf", None)
            if leaf is None:
                raise ValueError(
                    "native int8 commits need every float leaf encoded "
                    "(Int8Codec(min_size=1), as run_async_training sets)")
            if leaf.get("dt", "float32") != "float32":
                # the C++ fold applies q·scale in f32: another wire dtype
                # would part the center from Int8Codec.decode's
                raise ValueError(
                    f"leaf {i}: the native int8 wire carries float32 leaves "
                    f"only, got {leaf['dt']!r}; use ps_transport='socket'")
            q = np.ravel(leaf["q"], order="C")
            if q.size != size:
                raise ValueError(f"leaf {i}: blob size {q.size} != spec "
                                 f"size {size}")
            qv[off:off + size] = q
            scales[i] = leaf["s"]
            off += size
        lens = np.asarray(self.spec.sizes, np.uint64)
        rc = self._lib.dkps_client_commit_int8(
            self._handle, qv.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _f32p(scales), len(leaves))
        if rc != 0:
            raise ConnectionError("dkps int8 commit failed (server gone?)")

    def set_timeout(self, seconds: float | None) -> None:
        """Bound every later round trip (None blocks)."""
        ms = 0 if seconds is None else max(1, int(seconds * 1000))
        self._lib.dkps_client_set_timeout_ms(self._handle, ms)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dkps_client_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["FlatSpec", "NativeSocketParameterServer", "NativePSClient",
           "fold_mode"]
