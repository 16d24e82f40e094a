"""Socket front end for the generation engine.

Port of ``distkeras_tpu/serving/server.py`` (``generate`` and ``stats``
actions). Restricted-pickle frames (``networking.py``), one handler thread
per connection. The client sends ``{"action": "generate", "prompt": int32
array, "max_new_tokens": n, ...sampling knobs...}`` and blocks for ``{"ok":
True, "tokens": int32 array, "new_tokens": n}``. While a request is in
flight the handler polls the connection: a client that dies mid-generation
is detected by its EOF, its request is cancelled, and the engine frees its
cache blocks the next iteration. ``stop(drain=True)`` stops admission,
lets in-flight requests finish, then closes. ``register_with`` publishes
the replica into a membership directory (``directory/``) under a renewed
lease, which ``stop`` withdraws.
"""

from __future__ import annotations

import select
import socket
import threading

import numpy as np

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import ProtocolError, ServerBusyError
from distkeras_tpu_torch.serving.scheduler import GenerationEngine

_SAMPLING_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p",
                  "seed", "eos_id", "request_id", "slo_class", "tenant")


class GenerationServer:
    """Threaded TCP service around a :class:`GenerationEngine`.

    ``initialize()`` binds (an ephemeral port resolves into ``.port``),
    ``start()`` runs the accept loop and the engine thread; ``stop()``
    drains gracefully by default."""

    def __init__(self, engine: GenerationEngine, host: str = "127.0.0.1",
                 port: int = 0, poll_interval: float = 0.05):
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.poll_interval = float(poll_interval)
        self._server_sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._handlers: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._running = False
        self.connections_ = 0
        self.dead_connections_ = 0
        # the membership directory: register_with() publishes this replica
        # under the "serve" role with a renewed lease, so a
        # RoutedGenerationClient finds it, and a killed replica's entry
        # ages out
        self._dir_reg: tuple | None = None   # (client, key, ttl, epoch)
        self._dir_renewer: threading.Thread | None = None
        self._dir_stop = threading.Event()

    def initialize(self) -> None:
        self._server_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     1)
        self._server_sock.bind((self.host, self.port))
        self.port = self._server_sock.getsockname()[1]
        self._server_sock.listen(64)
        self._running = True

    def start(self) -> None:
        if self._server_sock is None:
            self.initialize()
        self.engine.start()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
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
                self.connections_ += 1
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._handlers = [h for h in self._handlers if h.is_alive()]
            self._handlers.append(t)

    @staticmethod
    def _peer_dead(conn: socket.socket) -> bool:
        """EOF probe without consuming data: readable + empty peek means
        the peer closed."""
        try:
            p = select.poll()
            p.register(conn, select.POLLIN)
            if not p.poll(0):
                return False
            return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _serve_generate(self, conn: socket.socket, msg: dict) -> None:
        try:
            prompt = np.asarray(msg["prompt"], np.int32)
            knobs = {k: msg[k] for k in _SAMPLING_KEYS if k in msg}
            req = self.engine.submit(prompt, **knobs)
        except ServerBusyError as e:
            networking.send_data(conn, {"error": "busy", "message": str(e)})
            return
        except (ValueError, TypeError, KeyError) as e:
            networking.send_data(conn, {"error": "bad_request",
                                        "message": str(e)})
            return
        # watch the connection while waiting: a client killed mid-stream
        # must free its blocks, not ride the batch to the end
        while not req.wait(self.poll_interval):
            if self._peer_dead(conn):
                self.engine.cancel(req)
                with self._conns_lock:
                    self.dead_connections_ += 1
                raise ConnectionResetError(
                    f"client died mid-generation ({req.id} cancelled)")
        if req.state == "done":
            networking.send_data(conn, {
                "ok": True,
                "tokens": np.asarray(req.new_tokens, np.int32),
                "new_tokens": len(req.new_tokens),
                "request_id": req.id,
            })
        else:
            networking.send_data(conn, {
                "error": req.state,
                "message": req.error or req.state,
                "request_id": req.id,
                "retryable": req.state == "cancelled",
            })

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = networking.recv_data(conn)
                action = msg.get("action")
                if action == "generate":
                    self._serve_generate(conn, msg)
                elif action == "stats":
                    networking.send_data(conn, {"ok": True,
                                                "stats": self.stats()})
                else:
                    networking.send_data(conn, {
                        "error": "bad_request",
                        "message": f"unknown action {action!r}",
                    })
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def register_with(self, directory, key: str | None = None,
                      ttl: float = 5.0, epoch: int = 0) -> str:
        """Publish this replica into a membership directory (a
        ``DirectoryClient`` or its seeds): ``("serve", key) → (host,
        port)`` with a ``ttl`` lease that a background thread renews at a
        third of the lease, so the entry expires within one TTL of this
        replica's death and a router's next refresh drops it. The meta
        carries the engine's ``model_version`` and ``prefix_hit_rate()``,
        published again with every renewal. ``stop()`` withdraws the
        entry. Returns the registered key."""
        from distkeras_tpu_torch.directory.client import DirectoryClient

        if not isinstance(directory, DirectoryClient):
            directory = DirectoryClient(directory)
        if key is None:
            key = f"{self.host}:{self.port}"

        def publish():
            directory.publish(
                "serve", key, self.host, self.port, epoch=int(epoch),
                ttl=float(ttl),
                meta={"model_version": int(self.engine.model_version),
                      "prefix_hit_rate": float(
                          self.engine.prefix_hit_rate())})

        publish()
        self._dir_reg = (directory, key, float(ttl), int(epoch))
        self._dir_stop.clear()

        def renewer():
            while not self._dir_stop.wait(max(ttl / 3.0, 0.05)):
                try:
                    publish()
                except Exception:  # noqa: BLE001
                    pass   # directory weather: the next tick retries

        self._dir_renewer = threading.Thread(
            target=renewer, daemon=True, name="dk-serve-dir-renew")
        self._dir_renewer.start()
        return key

    def _withdraw_registration(self) -> None:
        self._dir_stop.set()
        if self._dir_renewer is not None:
            self._dir_renewer.join(timeout=2)
            self._dir_renewer = None
        reg, self._dir_reg = self._dir_reg, None
        if reg is not None:
            directory, key, _ttl, epoch = reg
            try:
                directory.withdraw("serve", key, epoch=epoch)
            except Exception:  # noqa: BLE001
                pass   # the lease's expiry is the backstop
            directory.close()   # a later request reconnects

    def stats(self) -> dict:
        s = self.engine.stats()
        with self._conns_lock:
            s["connections"] = self.connections_
            s["open_connections"] = len(self._conns)
            s["dead_connections"] = self.dead_connections_
        return s

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful by default: stop accepting, let every admitted request
        finish and its reply flush, then tear down; a directory
        registration is withdrawn first."""
        self._withdraw_registration()
        self._running = False
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        self.engine.stop(drain=drain, timeout=timeout)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._handlers:
            t.join(timeout=2)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)

    def _crash(self, timeout: float = 5.0) -> None:
        """Chaos seam: die like a killed process — no renewal and no
        withdrawal (the lease's expiry drops the entry), the engine
        stopped without a drain, the listener and every live connection
        shut mid-stream. ``stop()`` after it still joins the threads."""
        self._dir_stop.set()
        self._running = False
        self.engine.stop(drain=False, timeout=timeout)
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            for close in (lambda: c.shutdown(socket.SHUT_RDWR), c.close):
                try:
                    close()
                except OSError:
                    pass


class GenerationClient:
    """Blocking request/response client for :class:`GenerationServer`."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float | None = 30.0):
        self._sock = networking.connect(host, port, timeout=connect_timeout)
        self._sock.settimeout(None)

    def generate(self, prompt, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 eos_id: int | None = None, request_id: str | None = None,
                 slo_class: str = "default",
                 tenant: str = "default") -> np.ndarray:
        networking.send_data(self._sock, {
            "action": "generate",
            "prompt": np.asarray(prompt, np.int32),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": top_k, "top_p": top_p, "seed": int(seed),
            "eos_id": eos_id, "request_id": request_id,
            "slo_class": str(slo_class), "tenant": str(tenant),
        })
        r = networking.recv_data(self._sock)
        if r.get("error") == "busy":
            raise ServerBusyError(r.get("message", "server busy"),
                                  peer=networking._peer_of(self._sock))
        if "error" in r:
            raise ProtocolError(
                f"server rejected request: {r['error']}: "
                f"{r.get('message', '')}",
                peer=networking._peer_of(self._sock),
                retryable=bool(r.get("retryable")),
            )
        return np.asarray(r["tokens"], np.int32)

    def stats(self) -> dict:
        networking.send_data(self._sock, {"action": "stats"})
        return networking.recv_data(self._sock)["stats"]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
