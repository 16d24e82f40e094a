"""Shared-memory ring transport: the colocated fast lane
(``ps_transport="shm"``).

Port of ``distkeras_tpu/shm.py``. Every frame between a worker and the
parameter server moves through an mmap'd pair of single-producer,
single-consumer rings (one ``multiprocessing.shared_memory`` segment per
worker↔PS connection), so a steady-state exchange makes no syscall and the
O(model) payload is written once into the ring and folded by the server
straight from the mapped view: no pickle of the bulk arrays, no kernel
copies.

Layout (one segment per connection, created and unlinked by the server)::

    [0..4096)                header: magic, ring capacity, pids, closed
                             flags; head/tail cursors on their own lines
    [4096 .. 4096+cap)       client→server ring (requests)
    [4096+cap .. 4096+2cap)  server→client ring (replies)

Each ring is a byte pipe (head and tail are monotonic u64 byte counters;
the writer owns head, the reader tail) carrying length-prefixed records, a
u64 word (``flags<<56 | length``) then the payload:

- **pickle records** (``FLAG_PKL``): the socket wire's frames exactly, the
  8-byte big-endian length prefix and the restricted-pickle payload,
  decoded by :func:`networking.decode_frame`. They stream through the ring
  with wraparound and progressive publication, so a record larger than
  the ring drains through it in pieces: the oversize **spill** path.
- **bulk records** (``FLAG_BULK``): ndarray leaves are lifted out of the
  message, replaced by ``(tag, offset, dtype, shape)`` markers in a small
  pickled skeleton, and written once into a 64-byte-aligned contiguous
  region of the ring; the receiver rebuilds the tree as numpy views over
  the mapped ring and releases the region once the fold or copy consumed
  it. A bulk record is contiguous (a pad record skips the ring's tail when
  it would wrap) and at most half the ring; anything larger spills.
- **pad records** (``FLAG_PAD``): dead bytes both sides skip.

Both endpoints live in one process (the colocated regime this transport
is for): a writer bumps its cursor and notifies a per-segment condition,
so a blocked peer wakes at once; a cross-process peer falls back to the
same loop's 0.5 ms slices. Every slice re-checks liveness (the peer's
closed flag and, across processes, its pid): a peer that dies mid-record
raises a retryable :class:`~distkeras_tpu_torch.networking.PeerDeadError`
and never wedges the other side, and the server unlinks a connection's
segment when its handler exits, so ``/dev/shm`` never leaks.

The port names its segments ``dktshm_*`` and :func:`segment_inventory`
scans only that prefix: the JAX package's ``dkshm_*`` segments are its
own, so the two packages' leak checks never count each other's.

The header (magic, offsets) is the JAX package's, byte for byte (the
native core's ring lane reads the same layout). The fault-injection seam
(``networking._fault_hook``) fires at the top of every message send and
receive, so a ``FaultPlan`` tears rings as it tears sockets. With the
membership directory's rendezvous installed (:func:`set_rendezvous`,
``directory.install_shm_rendezvous``) every segment minted is published
under the directory's ``shm`` role and withdrawn when it is unlinked.
"""

from __future__ import annotations

import itertools
import os
import pickle
import socket as _socket
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Any

import numpy as np

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import (
    FencedEpochError,
    PeerDeadError,
    ProtocolError,
)
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.parallel.compression import (
    _resolve_dtype,
    maybe_decode,
    validate_pull_compression,
)
from distkeras_tpu_torch.parameter_servers import (
    ParameterServerClient,
    SocketParameterServer,
)

Tree = Any

#: per-direction ring capacity (bytes): one exchange moves about 2× the
#: model through the rings (delta in, center out, one ring each); /dev/shm
#: charges only the pages touched
DEFAULT_RING_BYTES = 8 * 1024 * 1024

#: the port's segment-name prefix (the JAX package's is ``dkshm``)
SEGMENT_PREFIX = "dktshm"

_HDR_BYTES = 4096
_MAGIC = 0x31304D48534B44  # "DKSHM01" little-endian: the shared header
_OFF_MAGIC = 0
_OFF_CAP = 8
# cursors on their own cache lines: written by different threads at frame
# rate
_OFF_C2S_HEAD = 64
_OFF_C2S_TAIL = 128
_OFF_S2C_HEAD = 192
_OFF_S2C_TAIL = 256
_OFF_CLIENT_PID = 320
_OFF_SERVER_PID = 328
_OFF_CLIENT_CLOSED = 384
_OFF_SERVER_CLOSED = 448

_WORD = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_FLAG_SHIFT = 56
_LEN_MASK = (1 << _FLAG_SHIFT) - 1
FLAG_PKL = 0
FLAG_BULK = 1
FLAG_PAD = 0x7F

#: bulk leaf marker tag in the skeleton tree
_LEAF_TAG = "__dkshm__"

#: condvar wait slice (in-process peers are notified; cross-process ones
#: poll at this cadence)
_WAIT_SLICE = 0.0005
#: cadence of the cross-process peer-pid liveness probe during waits
_LIVENESS_PERIOD = 0.25

_seg_counter = itertools.count()

# process-local registry of live segments: every mint registers, every
# unlink unregisters; segment_inventory() reads /dev/shm where it exists
# and this registry elsewhere
_SEG_REGISTRY: dict[str, int] = {}
_SEG_REGISTRY_LOCK = threading.Lock()

# the rendezvous across processes: with a membership directory installed
# (``directory.install_shm_rendezvous``), every mint publishes the
# segment's name under the directory's "shm" role and every unlink
# withdraws it, so separate trainer processes on one host find each
# other's segments by name. The process registry above stays the fallback
# without one. Both callbacks are best effort: a directory outage never
# fails a mint
_RENDEZVOUS: tuple | None = None   # (publish(name, size), withdraw(name))


def set_rendezvous(publish, withdraw) -> None:
    """Install the rendezvous callbacks for this process's segments (one
    rendezvous at a time: the directory is one a process)."""
    global _RENDEZVOUS
    _RENDEZVOUS = (publish, withdraw)


def clear_rendezvous(publish=None) -> None:
    """Uninstall the rendezvous (only the one ``publish`` installed, when
    given, so a stale uninstaller cannot clear a newer one)."""
    global _RENDEZVOUS
    if publish is None or (_RENDEZVOUS is not None
                           and _RENDEZVOUS[0] is publish):
        _RENDEZVOUS = None


def unregister_segment(name: str) -> None:
    """Drop one segment from the live-inventory registry (every unlink
    path calls it) and withdraw it from the rendezvous."""
    with _SEG_REGISTRY_LOCK:
        _SEG_REGISTRY.pop(name, None)
    rdv = _RENDEZVOUS
    if rdv is not None:
        try:
            rdv[1](name)
        except Exception:  # noqa: BLE001
            pass   # best effort: the directory's lease is the backstop


def _unlink_segment(seg: shared_memory.SharedMemory) -> None:
    """Close this process's mapping of ``seg`` and remove its name: the
    one place a segment leaves /dev/shm and the registry. A live export of
    the mapping (a client's views, the native lane's pin) keeps the pages
    until it goes; the name goes at once."""
    try:
        seg.close()
    except BufferError:
        pass
    try:
        seg.unlink()
    except FileNotFoundError:
        pass
    unregister_segment(seg.name)


def segment_inventory() -> dict:
    """The port's live segments (``dktshm*``): names and sizes from a
    /dev/shm scan where the OS has one (segments of other processes on the
    host too), else from the process-local registry. An empty list after a
    run is the no-leak proof."""
    segs = []
    shm_dir = "/dev/shm"
    if os.path.isdir(shm_dir):
        for fn in sorted(os.listdir(shm_dir)):
            if not fn.startswith(SEGMENT_PREFIX):
                continue
            try:
                size = os.stat(os.path.join(shm_dir, fn)).st_size
            except OSError:
                continue  # unlinked between listdir and stat
            segs.append({"name": fn, "bytes": int(size)})
    else:
        with _SEG_REGISTRY_LOCK:
            segs = [{"name": n, "bytes": b}
                    for n, b in sorted(_SEG_REGISTRY.items())]
    return {"count": len(segs),
            "total_bytes": sum(s["bytes"] for s in segs),
            "segments": segs}


def mint_segment(name_prefix: str,
                 ring_bytes: int) -> shared_memory.SharedMemory:
    """Create one header-initialised segment: the one place the name
    scheme and the header are written."""
    seg = shared_memory.SharedMemory(
        create=True,
        name=f"{name_prefix}_{os.getpid()}_{next(_seg_counter)}",
        size=_HDR_BYTES + 2 * int(ring_bytes))
    _WORD.pack_into(seg.buf, _OFF_MAGIC, _MAGIC)
    _WORD.pack_into(seg.buf, _OFF_CAP, int(ring_bytes))
    with _SEG_REGISTRY_LOCK:
        _SEG_REGISTRY[seg.name] = seg.size
    rdv = _RENDEZVOUS
    if rdv is not None:
        try:
            rdv[0](seg.name, seg.size)
        except Exception:  # noqa: BLE001
            pass   # best effort: a mint never fails on a directory outage
    return seg


def _align64(n: int) -> int:
    return (n + 63) & ~63


# -- process-local wakeups ----------------------------------------------------
#
# Both endpoints of a segment in one process share a Condition keyed by the
# segment's name: bumping a cursor notifies it. The waiter re-checks its
# predicate inside the condition's lock before waiting, and the notifier
# publishes the cursor before taking that lock, so no wakeup is lost.

_WAKERS: dict[str, threading.Condition] = {}
_WAKERS_LOCK = threading.Lock()


def _waker_for(name: str) -> threading.Condition:
    with _WAKERS_LOCK:
        return _WAKERS.setdefault(name, threading.Condition())


def _waker_drop(name: str) -> None:
    with _WAKERS_LOCK:
        _WAKERS.pop(name, None)


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return True  # never stamped: no verdict
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class _ShmConn:
    """One endpoint of a segment's ring pair, with two layers over the
    rings:

    - the message layer (``send_msg`` / ``recv_msg``): pickle-lane frames
      and the zero-copy bulk frames of the shm handler and client;
    - a socket-like byte layer (``sendall`` / ``recv`` / ``settimeout`` /
      ``gettimeout`` / ``getpeername`` / ``close``), so
      ``networking.send_data`` / ``recv_data``, and with them every action
      :class:`ParameterServerClient` inherits, run over the ring
      unchanged. Byte reads consume pickle records; a bulk record there is
      a protocol violation.
    """

    def __init__(self, seg: shared_memory.SharedMemory, side: str,
                 waker: threading.Condition):
        if side not in ("client", "server"):
            raise ValueError(
                f"side must be 'client' or 'server', got {side!r}")
        self._seg = seg
        self._buf = seg.buf
        self._name = seg.name
        self._side = side
        self._waker = waker
        (magic,) = _WORD.unpack_from(self._buf, _OFF_MAGIC)
        if magic != _MAGIC:
            raise ProtocolError(f"segment {seg.name} is not a ring segment",
                                retryable=False)
        (self._cap,) = _WORD.unpack_from(self._buf, _OFF_CAP)
        if side == "client":
            self._tx_head, self._tx_tail = _OFF_C2S_HEAD, _OFF_C2S_TAIL
            self._rx_head, self._rx_tail = _OFF_S2C_HEAD, _OFF_S2C_TAIL
            self._my_closed, self._peer_closed = (_OFF_CLIENT_CLOSED,
                                                  _OFF_SERVER_CLOSED)
            self._peer_pid_off = _OFF_SERVER_PID
            _WORD.pack_into(self._buf, _OFF_CLIENT_PID, os.getpid())
        else:
            self._tx_head, self._tx_tail = _OFF_S2C_HEAD, _OFF_S2C_TAIL
            self._rx_head, self._rx_tail = _OFF_C2S_HEAD, _OFF_C2S_TAIL
            self._my_closed, self._peer_closed = (_OFF_SERVER_CLOSED,
                                                  _OFF_CLIENT_CLOSED)
            self._peer_pid_off = _OFF_CLIENT_PID
            _WORD.pack_into(self._buf, _OFF_SERVER_PID, os.getpid())
        self._tx_data = (_HDR_BYTES if side == "client"
                         else _HDR_BYTES + self._cap)
        self._rx_data = (_HDR_BYTES + self._cap if side == "client"
                         else _HDR_BYTES)
        self._timeout: float | None = None
        self._closed = False
        self._cur = 0  # bytes left in the current pickle record (byte reads)
        # a bulk record takes at most half the ring: one record in flight
        # while the previous one drains
        self._bulk_max = max(0, self._cap // 2 - 64)

    # -- cursor primitives ---------------------------------------------------

    def _torn(self, exc: BaseException) -> PeerDeadError:
        """A released mapping (the segment closed while this operation ran:
        a server stop racing a live peer) is peer death: reads raise
        ValueError and writes TypeError naming the memoryview. Anything
        else re-raises untouched."""
        if isinstance(exc, (ValueError, TypeError)) \
                and "memoryview" in str(exc):
            return PeerDeadError("shm segment torn down mid-operation",
                                 peer=self._name)
        raise exc

    def _u64(self, off: int) -> int:
        return _WORD.unpack_from(self._buf, off)[0]

    def _set_u64(self, off: int, v: int) -> None:
        _WORD.pack_into(self._buf, off, v)

    def _notify(self) -> None:
        with self._waker:
            self._waker.notify_all()

    def _check_alive(self, what: str) -> None:
        if self._buf is None or self._u64(self._my_closed):
            raise PeerDeadError(f"shm connection closed during {what}",
                                peer=self._name)
        if self._u64(self._peer_closed):
            raise PeerDeadError(f"shm peer closed its endpoint during {what}",
                                peer=self._name)
        pid = self._u64(self._peer_pid_off)
        if pid and pid != os.getpid() and not _pid_alive(pid):
            raise PeerDeadError(f"shm peer pid {pid} is gone (died "
                                f"mid-{what})", peer=self._name)

    def _wait(self, pred, what: str) -> None:
        """Block until ``pred()`` holds: condvar slices with liveness
        checks, and ``socket.timeout`` once ``settimeout``'s limit lapses,
        as a TCP stall would raise."""
        if pred():
            return
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        t_live = time.monotonic() + _LIVENESS_PERIOD
        cond = self._waker
        while True:
            self._check_alive(what)
            with cond:
                if pred():
                    return
                cond.wait(_WAIT_SLICE)
            if pred():
                return
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise _socket.timeout(
                    f"shm {what} timed out after {self._timeout}s")
            if now >= t_live:
                self._check_alive(what)
                t_live = now + _LIVENESS_PERIOD

    # -- byte layer: writer --------------------------------------------------

    def _tx_free(self) -> int:
        return self._cap - (self._u64(self._tx_head)
                            - self._u64(self._tx_tail))

    def _advance_head(self, n: int) -> None:
        self._set_u64(self._tx_head, self._u64(self._tx_head) + n)
        self._notify()

    def _skip_to_word_boundary_tx(self) -> None:
        """Record words never wrap: fewer than 8 bytes to the ring's end
        are dead bytes both sides skip."""
        pos = self._u64(self._tx_head) % self._cap
        rem = self._cap - pos
        if rem < 8:
            self._wait(lambda: self._tx_free() >= rem, "send")
            self._advance_head(rem)

    def _stream_tx(self, chunks) -> None:
        """Write bytes with wraparound, publishing as it goes so the reader
        drains at the same time: the spill path rides this."""
        for chunk in chunks:
            mv = memoryview(chunk)
            if mv.ndim != 1 or mv.itemsize != 1:
                mv = mv.cast("B")
            i, n = 0, len(mv)
            while i < n:
                self._wait(lambda: self._tx_free() > 0, "send")
                pos = self._u64(self._tx_head) % self._cap
                k = min(n - i, self._tx_free(), self._cap - pos)
                self._buf[self._tx_data + pos:self._tx_data + pos + k] = \
                    mv[i:i + k]
                i += k
                self._advance_head(k)

    def _send_record(self, flags: int, chunks) -> None:
        total = sum(len(memoryview(c).cast("B")) for c in chunks)
        self._skip_to_word_boundary_tx()
        self._stream_tx([_WORD.pack((flags << _FLAG_SHIFT) | total)])
        self._stream_tx(chunks)

    # -- byte layer: reader --------------------------------------------------

    def _rx_avail(self) -> int:
        return self._u64(self._rx_head) - self._u64(self._rx_tail)

    def _advance_tail(self, n: int) -> None:
        self._set_u64(self._rx_tail, self._u64(self._rx_tail) + n)
        self._notify()

    def _read_exact(self, n: int) -> bytearray:
        """Copy exactly ``n`` bytes out of the ring (wrapping, releasing as
        it goes so an oversize record streams through)."""
        out = bytearray(n)
        i = 0
        while i < n:
            self._wait(lambda: self._rx_avail() > 0, "recv")
            pos = self._u64(self._rx_tail) % self._cap
            k = min(n - i, self._rx_avail(), self._cap - pos)
            out[i:i + k] = self._buf[self._rx_data + pos:
                                     self._rx_data + pos + k]
            i += k
            self._advance_tail(k)
        return out

    def _next_record(self) -> tuple[int, int]:
        """Skip pads and dead bytes to the next record word; returns
        ``(flags, payload_length)`` with the word consumed."""
        while True:
            pos = self._u64(self._rx_tail) % self._cap
            rem = self._cap - pos
            if rem < 8:
                self._wait(lambda: self._rx_avail() >= rem, "recv")
                self._advance_tail(rem)
                continue
            self._wait(lambda: self._rx_avail() >= 8, "recv")
            (word,) = _WORD.unpack_from(self._buf, self._rx_data + pos)
            flags, length = word >> _FLAG_SHIFT, word & _LEN_MASK
            if flags == FLAG_PAD:
                self._wait(lambda: self._rx_avail() >= 8 + length, "recv")
                self._advance_tail(8 + length)
                continue
            self._advance_tail(8)
            return flags, length

    # -- the socket-like surface (networking.send_data / recv_data) ----------

    def sendall(self, data) -> None:
        if self._closed:
            raise PeerDeadError("send on closed shm connection",
                                peer=self._name)
        try:
            self._send_record(FLAG_PKL, [data])
        except (ValueError, TypeError) as e:
            raise self._torn(e) from e

    def recv(self, n: int) -> bytes:
        try:
            if self._cur == 0:
                flags, length = self._next_record()
                if flags != FLAG_PKL:
                    raise ProtocolError(
                        f"bulk shm record (flags={flags}) in a byte-stream "
                        f"read: protocol violation", retryable=False,
                        peer=self._name)
                self._cur = length
            self._wait(lambda: self._rx_avail() > 0, "recv")
            pos = self._u64(self._rx_tail) % self._cap
            k = min(n, self._cur, self._rx_avail(), self._cap - pos)
            out = bytes(self._buf[self._rx_data + pos:
                                  self._rx_data + pos + k])
            self._advance_tail(k)
            self._cur -= k
            return out
        except (ValueError, TypeError) as e:
            raise self._torn(e) from e

    def settimeout(self, t: float | None) -> None:
        self._timeout = None if t is None else float(t)

    def gettimeout(self) -> float | None:
        return self._timeout

    def getpeername(self) -> str:
        return f"shm:{self._name}"

    def close(self) -> None:
        """Flag this endpoint closed and wake the peer; unlinking the
        segment is the server's job (it created the name)."""
        if self._closed:
            return
        self._closed = True
        if self._buf is not None:
            try:
                self._set_u64(self._my_closed, 1)
            except (ValueError, TypeError):
                pass  # segment already torn down under us
        self._notify()

    # -- message layer -------------------------------------------------------

    def send_msg(self, msg: dict, bulk: bool = False) -> None:
        """One framed message. ``bulk=True`` ships ndarray leaves on the
        zero-copy lane when they fit (at most half the ring, one
        contiguous aligned region); otherwise, and for every control frame,
        the pickle lane carries the socket wire's frame bytes, streamed
        with wraparound (the spill path)."""
        if networking._fault_hook is not None:
            networking._fault_hook("send", self)
        if self._closed:
            raise PeerDeadError("send on closed shm connection",
                                peer=self._name)
        try:
            if bulk:
                enc = self._encode_bulk(msg)
                if enc is not None:
                    self._send_bulk(*enc)
                    return
            payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            self._send_record(
                FLAG_PKL, [networking._LEN.pack(len(payload)), payload])
        except (ValueError, TypeError) as e:
            raise self._torn(e) from e

    def _encode_bulk(self, msg: dict):
        """Lift ndarray leaves out of ``msg``: ``(skeleton pickle, [(arr,
        offset)], payload length)``, or None when the record would not fit
        the bulk lane (the caller spills) or holds no array."""
        leaves: list[tuple[np.ndarray, int]] = []
        state = {"off": 0}

        def walk(o):
            if isinstance(o, np.ndarray):
                arr = np.ascontiguousarray(o)
                off = _align64(state["off"])
                state["off"] = off + arr.nbytes
                leaves.append((arr, off))
                return (_LEAF_TAG, off, arr.dtype.name, tuple(arr.shape))
            if isinstance(o, dict):
                return {k: walk(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(walk(v) for v in o)
            return o

        skel_tree = walk(msg)
        if not leaves:
            return None  # a control frame: the pickle lane is cheaper
        skel = pickle.dumps(skel_tree, protocol=pickle.HIGHEST_PROTOCOL)
        payload_len = _align64(_U32.size + len(skel)) + state["off"]
        if 8 + payload_len > self._bulk_max:
            return None  # oversize: spill through the pickle lane
        return skel, leaves, payload_len

    def _send_bulk(self, skel: bytes, leaves, payload_len: int) -> None:
        total = 8 + payload_len
        # contiguity: pad to the ring's end when the record would wrap
        pos = self._u64(self._tx_head) % self._cap
        rem = self._cap - pos
        if rem < total:
            self._wait(lambda: self._tx_free() >= rem, "send")
            if rem >= 8:
                _WORD.pack_into(self._buf, self._tx_data + pos,
                                (FLAG_PAD << _FLAG_SHIFT) | (rem - 8))
            self._advance_head(rem)
        self._wait(lambda: self._tx_free() >= total, "send")
        base = self._tx_data + (self._u64(self._tx_head) % self._cap)
        _WORD.pack_into(self._buf, base,
                        (FLAG_BULK << _FLAG_SHIFT) | payload_len)
        _U32.pack_into(self._buf, base + 8, len(skel))
        self._buf[base + 8 + _U32.size:
                  base + 8 + _U32.size + len(skel)] = skel
        leaf_base = base + 8 + _align64(_U32.size + len(skel))
        for arr, rel in leaves:
            if arr.nbytes == 0:
                continue
            view = np.frombuffer(self._buf, dtype=np.uint8, count=arr.nbytes,
                                 offset=leaf_base + rel)
            view[:] = arr.reshape(-1).view(np.uint8)  # the one copy
        self._advance_head(total)

    def recv_msg(self, copy: bool = False):
        """→ ``(msg, raw, release)``. ``raw`` is a pickle-lane record's
        frame bytes (None for bulk). ``release`` is None unless the
        message holds live ring views (bulk, ``copy=False``): the caller
        calls it once the views are consumed (the ring space stays pinned
        until then). ``copy=True`` copies the views out and releases before
        returning."""
        if networking._fault_hook is not None:
            networking._fault_hook("recv", self)
        try:
            flags, length = self._next_record()
            if flags == FLAG_PKL:
                if length > networking.MAX_FRAME_BYTES + 8:
                    raise ProtocolError(
                        f"shm record of {length} bytes exceeds the frame "
                        f"cap", frame_size=int(length), peer=self._name,
                        retryable=False)
                (n,) = networking._LEN.unpack(self._read_exact(8))
                if n != length - 8:
                    raise ProtocolError(
                        f"shm pickle record length mismatch ({n} vs "
                        f"{length - 8})", peer=self._name, retryable=False)
                raw = bytes(self._read_exact(n))
                return networking.decode_frame(raw), raw, None
            if flags != FLAG_BULK:
                raise ProtocolError(f"unknown shm record flags {flags}",
                                    peer=self._name, retryable=False)
            self._wait(lambda: self._rx_avail() >= length, "recv")
            base = self._rx_data + (self._u64(self._rx_tail) % self._cap)
            msg = self._decode_bulk(base, copy)
            if copy:
                self._advance_tail(length)
                return msg, None, None
        except (ValueError, TypeError) as e:
            raise self._torn(e) from e
        released = [False]

        def release():
            if not released[0]:
                released[0] = True
                try:
                    self._advance_tail(length)
                except (ValueError, TypeError) as e:
                    raise self._torn(e) from e

        return msg, None, release

    def _decode_bulk(self, base: int, copy: bool):
        (skel_len,) = _U32.unpack_from(self._buf, base)
        skel = bytes(self._buf[base + _U32.size:base + _U32.size + skel_len])
        tree = networking.decode_frame(skel)  # the restricted unpickler
        leaf_base = base + _align64(_U32.size + skel_len)

        def rebuild(o):
            if isinstance(o, tuple) and len(o) == 4 and o[0] == _LEAF_TAG:
                _, rel, dtname, shape = o
                dt = _resolve_dtype(dtname)
                count = int(np.prod(shape, dtype=np.int64))
                if count == 0:
                    return np.empty(shape, dt)
                view = np.frombuffer(self._buf, dtype=dt, count=count,
                                     offset=leaf_base + rel).reshape(shape)
                return np.array(view) if copy else view
            if isinstance(o, dict):
                return {k: rebuild(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(rebuild(v) for v in o)
            return o

        return rebuild(tree)


class ShmParameterServer(SocketParameterServer):
    """The parameter server over shared-memory rings (``ps_transport=
    "shm"``), colocated only: the segments are this process's. The action
    dispatch, the fold path, the center's EMA, the WAL, fencing,
    heartbeats, the stats and the trace spans are the socket server's;
    only the framing differs.
    Requests arrive through :meth:`_ShmConn.recv_msg` (pickle or bulk
    lane), and pull and exchange replies ship the center's leaves on the
    bulk lane, written once from the immutable snapshot into the ring. A
    durable server's commits arrive on the pickle lane, so the WAL logs
    their frames verbatim (``REC_COMMIT_WIRE``), as over TCP.

    :meth:`connect_shm` creates a connection's segment and its handler
    thread; the segment is unlinked when the handler exits (client close,
    server stop or crash, or the lease eviction of an abandoned worker),
    so /dev/shm never leaks. ``attach_standby`` refuses: the transport is
    colocated-only, and replication streams are the socket server's. A shard
    server of a sharded center (``sharding/``) answers the ``shard_map``
    handshake through the same dispatch, so each (worker, shard) ring pair
    is checked against the plan."""

    def __init__(self, center: Tree, rule, num_workers: int,
                 ring_bytes: int = DEFAULT_RING_BYTES,
                 ema_decay: float | None = None,
                 lease_timeout: float | None = None,
                 wal_dir: str | None = None, snapshot_every: int = 100,
                 fence_epoch: int = 0, wal_group_window: int = 8,
                 wal_group_interval: float = 0.25):
        super().__init__(center, rule, num_workers, host="shm", port=0,
                         ema_decay=ema_decay,
                         lease_timeout=lease_timeout, wal_dir=wal_dir,
                         snapshot_every=snapshot_every,
                         fence_epoch=fence_epoch,
                         wal_group_window=wal_group_window,
                         wal_group_interval=wal_group_interval)
        if int(ring_bytes) < _HDR_BYTES:
            raise ValueError(
                f"ring_bytes must be >= {_HDR_BYTES}, got {ring_bytes}")
        self.ring_bytes = int(ring_bytes)
        # segment records {"seg", "conn", "wid", "released"}, under the
        # inherited _conns_lock
        self._segments: list[dict] = []
        self._handlers: list[threading.Thread] = []

    # -- lifecycle (no TCP anywhere) -----------------------------------------

    def initialize(self) -> None:
        self._running = True

    def start(self) -> None:
        pass  # no accept loop: connect_shm starts each handler

    def run(self) -> None:
        pass

    def attach_standby(self, host: str, port: int,
                       timeout: float = 10.0) -> None:
        raise NotImplementedError(
            "the shm transport is colocated-only; replication streams "
            "(standby/chain) are the socket transport's job: the trainers "
            "refuse ps_standby and ps_chain_length > 1 unless "
            "ps_transport='socket'")

    def connect_shm(self, worker_id: int) -> tuple[_ShmConn, dict]:
        """One worker↔PS connection: create the segment, start its handler
        thread, return the client endpoint and the handshake record
        (``wal_frames``: send commits on the pickle lane, so the WAL logs
        their frames verbatim)."""
        if not self._running:
            raise ConnectionRefusedError("shm parameter server is stopped")
        seg = mint_segment(SEGMENT_PREFIX, self.ring_bytes)
        waker = _waker_for(seg.name)
        srv_conn = _ShmConn(seg, "server", waker)
        cli_conn = _ShmConn(seg, "client", waker)
        rec = {"seg": seg, "conn": srv_conn, "wid": int(worker_id),
               "released": False}
        with self._conns_lock:
            raced_stop = not self._running  # stop() raced the mint
            if not raced_stop:
                self._segments.append(rec)
        if raced_stop:
            self._release_segment(rec)
            raise ConnectionRefusedError("shm parameter server is stopped")
        t = threading.Thread(target=self._serve_shm, args=(srv_conn, rec),
                             daemon=True, name=f"dktshm-handler-{worker_id}")
        t.start()
        self._handlers.append(t)
        return cli_conn, {"worker_id": int(worker_id),
                          "wal_frames": self._wal is not None}

    def _release_segment(self, rec: dict) -> None:
        """Close and unlink one connection's segment (idempotent): flag
        both endpoints closed, waking any blocked peer, then remove the
        /dev/shm name. The client's mapping stays valid until it drops its
        own references."""
        with self._conns_lock:
            if rec.get("released"):
                return
            rec["released"] = True
            if rec in self._segments:
                self._segments.remove(rec)
        seg = rec["seg"]
        rec["conn"].close()
        try:
            _WORD.pack_into(seg.buf, _OFF_SERVER_CLOSED, 1)
            _WORD.pack_into(seg.buf, _OFF_CLIENT_CLOSED, 1)
        except (ValueError, TypeError):
            pass
        cond = _waker_for(seg.name)
        with cond:
            cond.notify_all()
        _waker_drop(seg.name)
        _unlink_segment(seg)

    def _release_all(self) -> None:
        with self._conns_lock:
            recs = list(self._segments)
        for rec in recs:
            self._release_segment(rec)

    def ring_occupancy(self) -> list[dict]:
        """Per-connection ring occupancy read straight off the mapped
        headers (no locks taken on the rings, no syscalls): the used bytes
        of each direction's ring and the fuller direction's used fraction.
        The watchtower's scraper samples the max across connections into
        ``shm.ring_occupancy_frac``; near 1.0 a writer is about to block
        on a stalled reader (or the ring is undersized)."""
        with self._conns_lock:
            recs = list(self._segments)
        out = []
        for rec in recs:
            seg = rec["seg"]
            try:
                buf = seg.buf
                cap = _WORD.unpack_from(buf, _OFF_CAP)[0]
                c2s = (_WORD.unpack_from(buf, _OFF_C2S_HEAD)[0]
                       - _WORD.unpack_from(buf, _OFF_C2S_TAIL)[0])
                s2c = (_WORD.unpack_from(buf, _OFF_S2C_HEAD)[0]
                       - _WORD.unpack_from(buf, _OFF_S2C_TAIL)[0])
            except (ValueError, TypeError):
                continue   # racing a release: this segment is going away
            if cap <= 0:
                continue
            out.append({"name": seg.name, "worker_id": rec["wid"],
                        "cap": int(cap), "c2s_used": int(c2s),
                        "s2c_used": int(s2c),
                        "frac": max(int(c2s), int(s2c)) / int(cap)})
        return out

    def stop(self) -> None:
        if not self._running:
            self._close_durability()
            return
        self._running = False
        self._release_all()
        for t in self._handlers:
            t.join(timeout=5)
        self._close_durability()

    def _crash(self) -> None:
        """Chaos seam: tear every ring and abandon the WAL unflushed, as
        the socket server's crash does. The segments are still unlinked
        (a real kill would leave them to a janitor), so chaos tests leak
        nothing into /dev/shm."""
        self.crashed_ = True
        self._running = False
        self._release_all()
        if self._wal is not None:
            self._wal.abandon()

    def _on_evict(self, worker_ids) -> None:
        """A lapsed lease reclaims the zombie's transport too: its
        connections close, their handlers exit and the segments unlink."""
        super()._on_evict(worker_ids)
        wids = {int(w) for w in worker_ids}
        with self._conns_lock:
            recs = [r for r in self._segments if r["wid"] in wids]
        for rec in recs:
            self._release_segment(rec)

    # -- the handler ---------------------------------------------------------

    def _serve_shm(self, conn: _ShmConn, rec: dict) -> None:
        """The socket server's dispatch over ring framing, with pull and
        exchange replies on the bulk lane. A bulk commit or exchange folds
        straight from the mapped ring views; the region is released once
        the dispatch consumed it (request-reply keeps at most one record
        in flight, so the pin never blocks the sender)."""
        try:
            while True:
                msg, raw, release = conn.recv_msg()
                try:
                    action = msg.get("action")
                    if action in ("pull", "pull_int8", "exchange"):
                        if _trace.enabled():
                            _trace.set_corr(msg.get("corr"))
                        if action == "pull":
                            self._serve_pull_shm(conn, msg["worker_id"])
                        elif action == "pull_int8":
                            self._serve_compressed_pull_shm(
                                conn, msg["worker_id"])
                        else:
                            self._serve_exchange_shm(conn, msg, raw)
                    elif self._dispatch(conn, msg, raw):
                        break
                finally:
                    if release is not None:
                        release()
                    # drop the ring views now: a live view keeps the
                    # segment's mapping from closing
                    msg = None
        except (ConnectionError, EOFError, OSError, pickle.UnpicklingError):
            pass  # a torn ring, a dead peer, an injected fault
        finally:
            self._release_segment(rec)

    def _serve_pull_shm(self, conn: _ShmConn, worker_id: int) -> None:
        """The pull reply on the bulk lane: the immutable snapshot's leaves
        written once into the ring, counted once delivered."""
        with _trace.span("ps.pull"):
            snap, _ = self._begin_pull(worker_id, compressed=False)
            self._begin_reply()
            try:
                conn.send_msg({"weights": snap}, bulk=True)
                self._count(pulls=1, bytes_out=self._center_nbytes)
            finally:
                self._end_reply()

    def _serve_compressed_pull_shm(self, conn: _ShmConn,
                                   worker_id: int) -> None:
        """The int8 pull; a reply that never went out rolls its residual
        advance back (unless a newer encode raced in)."""
        with _trace.span("ps.pull_int8"):
            snap, st = self._begin_pull(worker_id, compressed=True)
            with st.lock:
                blob, nbytes = self._encode_pull(st, snap)
                epoch = st.epoch
            self._send_blob_shm(conn, {"weights": blob}, st, snap, blob,
                                epoch, nbytes, fused=0)

    def _send_blob_shm(self, conn, reply, st, snap, blob, epoch, nbytes,
                       fused):
        self._begin_reply()
        try:
            conn.send_msg(reply, bulk=True)
            self._count(compressed_pulls=1, bytes_out=nbytes, fused=fused)
        except (ConnectionError, OSError):
            with st.lock:
                if st.epoch == epoch:
                    self._rollback_encode_locked(st, snap, blob)
            raise
        finally:
            self._end_reply()

    def _serve_exchange_shm(self, conn: _ShmConn, msg: dict,
                            raw: bytes | None) -> None:
        """The fused exchange over the rings: the commit folds from the
        request's mapped views (or, on a durable server, the pickle lane's
        frame, logged verbatim), the post-fold snapshot goes back on the
        bulk lane."""
        compressed = bool(msg.get("compressed"))
        with _trace.span("ps.exchange"):
            try:
                applied, snap, st = self._commit_impl(
                    msg["worker_id"], msg["payload"], seq=msg.get("seq"),
                    epoch=msg.get("epoch"), wire_frame=raw,
                    lag=bool(msg.get("lag")), fused=True,
                    compressed=compressed)
            except FencedEpochError as fe:
                conn.send_msg({"error": "fenced", "epoch": fe.server_epoch})
                return
            if not compressed:
                self._begin_reply()
                try:
                    conn.send_msg({"ok": True, "dup": not applied,
                                   "weights": snap}, bulk=True)
                    self._count(pulls=1, bytes_out=self._center_nbytes,
                                fused=1)
                finally:
                    self._end_reply()
                return
            with st.lock:
                blob, nbytes = self._encode_pull(st, snap)
                epoch = st.epoch
            self._send_blob_shm(conn, {"ok": True, "dup": not applied,
                                       "weights": blob}, st, snap, blob,
                                epoch, nbytes, fused=1)


class ShmPSClient(ParameterServerClient):
    """The worker's side of an shm connection: :class:`ParameterServerClient`
    over a ring pair. Control actions (ping, stats, fence, heartbeat,
    deregister, close) run through the inherited code, since
    ``networking.send_data`` / ``recv_data`` speak to the socket-like
    endpoint. The O(model) paths are the client's own: pull and exchange
    replies arrive on the bulk lane and are copied out of the ring before
    it is released; commit and exchange requests ship the delta's leaves
    on the bulk lane, written once into the ring and folded from the
    mapped view, except against a durable server, where they take the
    pickle lane so the WAL logs their frames verbatim."""

    def __init__(self, server: ShmParameterServer, worker_id: int,
                 pull_compression: str | None = None,
                 epoch: int | None = None):
        self.pull_compression = validate_pull_compression(pull_compression)
        self.worker_id = int(worker_id)
        self.epoch = None if epoch is None else int(epoch)
        conn, info = server.connect_shm(self.worker_id)
        self._sock = conn  # the inherited actions speak to this endpoint
        self._wal_frames = bool(info.get("wal_frames"))

    def _bulk_request(self, msg: dict) -> dict:
        self._sock.send_msg(msg, bulk=not self._wal_frames)
        reply, _raw, _release = self._sock.recv_msg(copy=True)
        return reply

    def pull(self, worker_id: int | None = None) -> Tree:
        action = "pull_int8" if self.pull_compression == "int8" else "pull"
        self._sock.send_msg({"action": action, "worker_id": self.worker_id})
        reply, _raw, _release = self._sock.recv_msg(copy=True)
        self._check_reply(reply, "pull")
        return maybe_decode(reply["weights"])

    def commit(self, worker_id: int | None, payload: Tree,
               seq: int | None = None) -> None:
        ack = self._bulk_request(self._payload_msg("commit", payload, seq))
        self._check_reply(ack, "commit")

    def exchange(self, worker_id: int | None, payload: Tree,
                 seq: int | None = None, lag: bool = False) -> Tree:
        msg = self._payload_msg("exchange", payload, seq)
        if self.pull_compression == "int8":
            msg["compressed"] = True
        if lag:
            msg["lag"] = True
        reply = self._bulk_request(msg)
        self._check_reply(reply, "exchange")
        return maybe_decode(reply["weights"])


__all__ = ["ShmParameterServer", "ShmPSClient", "segment_inventory",
           "mint_segment", "unregister_segment", "DEFAULT_RING_BYTES",
           "SEGMENT_PREFIX"]
