"""Transport: length-prefixed restricted-pickle frames over TCP.

The port's own copy of the framing in ``distkeras_tpu/networking.py``: an
8-byte big-endian length and a pickled payload, decoded by an unpickler that
resolves no globals beyond numpy array reconstruction, so a forged frame
cannot execute code, and a length cap so it cannot allocate without bound.
Frames carry dicts of primitives and numpy arrays; tensors are turned into
numpy arrays before any frame is built (the unpickler rejects a tensor).
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import struct
from typing import Any

_LEN = struct.Struct(">Q")

#: Upper bound on an accepted frame (a malformed length prefix must not
#: trigger a multi-GB allocation).
MAX_FRAME_BYTES = 2 * 1024 * 1024 * 1024


class ProtocolError(ConnectionError):
    """A framed wire operation failed or produced a malformed frame.
    ``retryable`` separates transient transport failures (peer died
    mid-frame) from protocol violations (oversized frames)."""

    def __init__(self, message: str, *, frame_size: int | None = None,
                 peer: str | None = None, retryable: bool = True):
        ctx = []
        if frame_size is not None:
            ctx.append(f"frame={frame_size}B")
        if peer:
            ctx.append(f"peer={peer}")
        super().__init__(f"{message} [{', '.join(ctx)}]" if ctx else message)
        self.frame_size = frame_size
        self.peer = peer
        self.retryable = retryable


class PeerDeadError(ProtocolError):
    """The other end of a shared-memory ring died or closed mid-operation.
    Retryable: the shm lane's equivalent of a torn TCP connection."""

    def __init__(self, message: str, *, peer: str | None = None):
        super().__init__(message, peer=peer, retryable=True)


class FencedEpochError(ProtocolError):
    """A parameter server rejected an operation carrying a stale fencing
    epoch. Not retryable against the same server: the mismatch is
    deterministic."""

    def __init__(self, message: str, *, client_epoch: int | None = None,
                 server_epoch: int | None = None, peer: str | None = None):
        ctx = ""
        if client_epoch is not None or server_epoch is not None:
            ctx = (f" (client epoch {client_epoch}, server epoch "
                   f"{server_epoch})")
        super().__init__(message + ctx, peer=peer, retryable=False)
        self.client_epoch = client_epoch
        self.server_epoch = server_epoch


class ShardMapMismatchError(ProtocolError):
    """A sharded-PS client is wired to the wrong shard (its shard-map
    handshake disagrees with the client's plan). Not retryable."""

    def __init__(self, message: str, *, peer: str | None = None):
        super().__init__(message, peer=peer, retryable=False)


class ServerBusyError(ProtocolError):
    """The serving tier's bounded admission queue is full — backpressure,
    not failure; retryable by design."""

    def __init__(self, message: str = "server busy: admission queue full",
                 *, peer: str | None = None):
        super().__init__(message, peer=peer, retryable=True)


def _peer_of(sock: socket.socket) -> str | None:
    """Best-effort peer label for error context (never raises)."""
    try:
        peer = sock.getpeername()
    except OSError:
        return None
    if isinstance(peer, tuple) and len(peer) >= 2:
        return f"{peer[0]}:{peer[1]}"
    return str(peer)


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickler for control frames: primitives + numpy arrays only."""

    _ALLOWED = {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy.core.numeric", "_frombuffer"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"frame tried to load disallowed global {module}.{name}"
        )


def determine_host_address() -> str:
    """Best-effort routable address of this host (the reference's
    ``determine_host_address``): the pod worker address from
    ``TPU_WORKER_HOSTNAMES``/``TPU_WORKER_ID`` when set, else the address
    of the interface the default route uses (a UDP ``connect`` selects it
    and sends no packet), else loopback."""
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    worker_id = os.environ.get("TPU_WORKER_ID", "")
    if hostnames and worker_id.isdigit():
        hosts = hostnames.split(",")
        if int(worker_id) < len(hosts) and hosts[int(worker_id)].strip():
            return hosts[int(worker_id)].strip()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def connect(host: str, port: int,
            timeout: float | None = 30.0) -> socket.socket:
    """Open a TCP connection with Nagle disabled (small-frame latency)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def send_data(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int,
                expected: int | None = None) -> bytes:
    """Read exactly ``n`` bytes; a mid-frame close raises a retryable
    ProtocolError naming the frame being lost."""
    chunks = []
    want = n
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"socket closed mid-frame ({want - n} of {want} bytes read)",
                frame_size=expected if expected is not None else want,
                peer=_peer_of(sock), retryable=True,
            )
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def decode_frame(raw: bytes) -> Any:
    """Decode one frame's payload through the restricted unpickler."""
    return _RestrictedUnpickler(io.BytesIO(raw)).load()


def recv_data(sock: socket.socket, max_bytes: int = MAX_FRAME_BYTES) -> Any:
    return recv_data_raw(sock, max_bytes)[0]


def recv_data_raw(sock: socket.socket,
                  max_bytes: int = MAX_FRAME_BYTES) -> tuple[Any, bytes]:
    """Like :func:`recv_data`, and also the frame's raw pickled bytes."""
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > max_bytes:
        # not retryable: the same frame would bust the cap on every retry
        raise ProtocolError(
            f"frame of {length} bytes exceeds the {max_bytes}-byte cap",
            frame_size=int(length), peer=_peer_of(sock), retryable=False,
        )
    raw = _recv_exact(sock, length, expected=int(length))
    return decode_frame(raw), raw
