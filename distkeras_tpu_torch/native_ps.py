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

The C++ core keeps the write-ahead log, fencing, leases, the center's EMA
and the trace ring of the whole design; this side never turns them on.
Asking for them raises ``NotImplementedError`` naming ``ROADMAP.md`` A7.6
or A8.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import time
from typing import Any

import numpy as np

from distkeras_tpu_torch import utils
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

#: EXCHANGE flags (dkps.cpp, action 14): bit 2 an int8 reply, bit 3 lag
_XCHG_INT8 = 4
_XCHG_LAG = 8

_A76 = "ROADMAP.md A7.6 (resilience: fencing, WAL, leases)"


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {item}")


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
    surface: ``initialize()`` binds (resolving an ephemeral port),
    ``start()`` runs the C++ accept loop, ``stop()`` shuts it down and
    joins every handler; ``get_model()`` and ``num_updates`` read the
    center under the C++ mutex."""

    def __init__(self, center: Tree, rule: MergeRule, num_workers: int,
                 host: str = "127.0.0.1", port: int = 0,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, fence_epoch: int = 0):
        if ema_decay is not None:
            raise _later("the native PS's center EMA",
                         "ROADMAP.md A8 (checkpoints and EMA)")
        if wal_dir is not None:
            raise _later("the native PS's write-ahead log", _A76)
        if lease_timeout is not None:
            raise _later("the native PS's worker leases", _A76)
        if fence_epoch:
            raise _later("the native PS's fencing epochs", _A76)
        self._lib = load_dkps()
        self.spec = FlatSpec(center)
        self.rule = rule
        self.num_workers = int(num_workers)
        self.host = host
        self.port = int(port)
        self._handle = None
        self._init_vec = self.spec.flatten(center)

    def initialize(self) -> None:
        mode, scale = fold_mode(self.rule, self.num_workers)
        h = self._lib.dkps_server_create(
            _f32p(self._init_vec), self.spec.n, mode, scale,
            self.host.encode(), self.port, -1.0, -1.0)
        if not h:
            raise OSError(f"dkps server failed to bind {self.host}:"
                          f"{self.port}")
        self._handle = h
        self.port = int(self._lib.dkps_server_port(h))
        # the pool gauge of stats(), as the Python PS reports it
        self._lib.dkps_server_set_pool_size(h, self.num_workers)
        self._t_start = time.monotonic()

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

    def stats(self) -> dict:
        """``ParameterServer.stats()``'s keys and derived values
        (``build_ps_stats``), from the C++ server's counters: operations,
        payload bytes, and the center mutex's wait and hold over its pull
        copies and folds."""
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
        if epoch is not None:
            raise _later("fenced native commits", _A76)
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
        if seq is not None:
            raise _later("deduplicated native commits (seq)", _A76)
        if is_encoded(payload):
            return self._commit_int8(payload)
        vec = np.ascontiguousarray(self.spec.flatten(payload))
        if self._lib.dkps_client_commit(self._handle, _f32p(vec)) != 0:
            raise ConnectionError("dkps commit failed (server gone?)")

    def exchange(self, worker_id: int | None, payload: Tree,
                 seq: int | None = None, lag: bool = False) -> Tree:
        """Fused commit + pull (EXCHANGE, action 14): one round trip folds
        ``payload`` and returns the post-fold center, on the compressed
        pull wire when ``pull_compression='int8'``; ``lag=True`` prices τ
        from this worker's previous pull. A codec-encoded commit has no
        fused frame: it takes the two-trip commit and pull."""
        if seq is not None:
            raise _later("deduplicated native commits (seq)", _A76)
        if is_encoded(payload):
            self.commit(worker_id, payload)
            return self.pull()
        vec = np.ascontiguousarray(self.spec.flatten(payload))
        out = np.empty(self.spec.n, dtype=np.float32)
        flags = ((_XCHG_INT8 if self.pull_compression == "int8" else 0)
                 | (_XCHG_LAG if lag else 0))
        sepoch = ctypes.c_uint64(0)
        rc = self._lib.dkps_client_exchange(
            self._handle, flags, 0, 0, _f32p(vec), _f32p(out),
            ctypes.byref(sepoch))
        if rc < 0:
            raise ConnectionError("dkps exchange failed (server gone?)")
        return self.spec.unflatten(out)

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
