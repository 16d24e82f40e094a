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
lease, which ``stop`` withdraws. :class:`ResilientGenerationClient`
reconnects and replays a request across a server's death or restart.

The flight recorder: ``trace=True`` or ``trace_dir=`` arms the span
recorder (``observability.trace``) for the server's lifetime, so every
request leaves its lifecycle spans (``serve.enqueue``, ``serve.queued``,
``serve.prefill``, the decode steps and ``serve.request``) stitched by
request id; ``stop()`` writes the timeline to ``trace_dir`` and sets
``trace_path_``. Only an enable the server made is undone at stop: a
recorder that was already on stays on.

Live deployment (``deploy/``): with a ``SnapshotStore`` of streamed model
versions in ``server.snapshots``, the ``deploy_activate`` action stages a
stored version onto the engine (``swap_params``: applied between decode
steps) and ``deploy_status`` reports the current, the staged and the
stored versions; the registration meta carries the current
``model_version``. A snapshot is the training center (the float params
by name); an int8 engine's model gets it quantized by
``models.lm.quantize_state_dict`` first.
"""

from __future__ import annotations

import os
import select
import socket
import threading
import time
from typing import Callable

import numpy as np

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import ProtocolError, ServerBusyError
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.serving.scheduler import GenerationEngine

_SAMPLING_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p",
                  "seed", "eos_id", "request_id", "slo_class", "tenant")


class GenerationServer:
    """Threaded TCP service around a :class:`GenerationEngine`.

    ``initialize()`` binds (an ephemeral port resolves into ``.port``),
    ``start()`` runs the accept loop and the engine thread; ``stop()``
    drains gracefully by default."""

    def __init__(self, engine: GenerationEngine, host: str = "127.0.0.1",
                 port: int = 0, poll_interval: float = 0.05,
                 trace: bool = False, trace_dir: str | None = None,
                 trace_sample: float = 1.0):
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.poll_interval = float(poll_interval)
        # the flight recorder (see the module docstring); _trace_owner
        # marks an enable this server made, the only one stop() undoes
        self.trace = bool(trace) or trace_dir is not None
        self.trace_dir = trace_dir
        self.trace_sample = float(trace_sample)
        self.trace_path_: str | None = None
        self._trace_owner = False
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
        # live deployment: a deploy.SnapshotStore of streamed versions,
        # which the deploy_activate action swaps the engine to
        self.snapshots = None
        # an attached observability Watchtower: the `metrics` action then
        # carries its alert ledger
        self.watchtower = None

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
        if self.trace and not _trace.enabled():
            _trace.enable(sample=self.trace_sample)
            self._trace_owner = True
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
                elif action == "deploy_activate":
                    # the rollout controller's activation: stage a stored
                    # snapshot, applied between decode steps
                    networking.send_data(conn, self._deploy_activate(msg))
                elif action == "deploy_status":
                    networking.send_data(conn, self._deploy_status())
                elif action == "metrics":
                    # the serving counters and the per-class latency
                    # summary as typed metrics: the one metrics_reply
                    # shape every server sends
                    from distkeras_tpu_torch.observability.metrics import (
                        metrics_reply,
                        serving_metrics,
                    )

                    networking.send_data(conn, metrics_reply(
                        serving_metrics(self.stats()), self.watchtower))
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

    def _deploy_activate(self, msg: dict) -> dict:
        version = int(msg["version"])
        policy = msg.get("policy", "drain")
        store = self.snapshots
        if store is None:
            return {"ok": False, "error": "no snapshot store attached"}
        snap = store.get(version)
        if snap is None:
            return {"ok": False, "error": f"unknown version {version}",
                    "versions": store.versions()}
        try:
            self.engine.swap_params(self._weights(snap.tree),
                                    snap.version, policy=policy)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "version": snap.version, "policy": policy}

    def _weights(self, tree: dict) -> dict:
        """The engine model's state dict carrying a snapshot's float
        ``tree``: as is for a float model, quantized for an int8 one."""
        import torch

        model = self.engine.model
        if getattr(model, "quant", False):
            from distkeras_tpu_torch.models.lm import quantize_state_dict

            return quantize_state_dict(model, tree)
        return {k: torch.as_tensor(v) for k, v in tree.items()}

    def _deploy_status(self) -> dict:
        staged = self.engine._staged_swap
        store = self.snapshots
        return {"ok": True, "model_version": self.engine.model_version,
                "staged_version": staged[1] if staged else None,
                "versions": store.versions() if store is not None else []}

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
        self._close_listener()
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
        if self.trace:
            if self.trace_dir is not None and _trace.enabled():
                self.trace_path_ = _trace.save(os.path.join(
                    self.trace_dir,
                    f"serve-trace-{os.getpid()}-{time.time_ns()}.json"))
            if self._trace_owner:
                _trace.disable()
                self._trace_owner = False

    def _close_listener(self) -> None:
        """Release the port at once. ``close()`` alone does not wake an
        ``accept()`` blocked in the accept thread, and the socket stays
        listening on the port until a connection arrives, so a server
        restarted on it fails to bind; ``shutdown`` wakes the accept."""
        if self._server_sock is None:
            return
        try:
            self._server_sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server_sock.close()
        except OSError:
            pass
        if self._accept_thread is not None \
                and self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=2)

    def _crash(self, timeout: float = 5.0) -> None:
        """Chaos seam: die like a killed process — no renewal and no
        withdrawal (the lease's expiry drops the entry), the engine
        stopped without a drain, the listener and every live connection
        shut mid-stream. ``stop()`` after it still joins the threads."""
        self._dir_stop.set()
        self._running = False
        self.engine.stop(drain=False, timeout=timeout)
        self._close_listener()
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

    def deploy_activate(self, version: int, policy: str = "drain") -> dict:
        """Hot-swap the server to its stored snapshot ``version`` (the
        rollout controller's activation). Returns the server's reply
        (``ok=False`` with the stored versions on a miss)."""
        networking.send_data(self._sock, {
            "action": "deploy_activate", "version": int(version),
            "policy": str(policy)})
        return networking.recv_data(self._sock)

    def deploy_status(self) -> dict:
        """The current and staged model versions and the stored ones."""
        networking.send_data(self._sock, {"action": "deploy_status"})
        return networking.recv_data(self._sock)

    def wait_for_swap(self, timeout: float = 10.0,
                      poll: float = 0.02) -> dict:
        """Block until no swap is staged (a drain landed, a refill
        applied) and return the final status; ``TimeoutError`` with the
        stuck status when ``timeout`` passes first (a drain behind a
        request that never finishes)."""
        import time

        deadline = time.monotonic() + float(timeout)
        while True:
            status = self.deploy_status()
            if status.get("staged_version") is None:
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"swap still staged after {timeout}s: {status}")
            time.sleep(poll)

    def set_timeout(self, seconds: float | None) -> None:
        self._sock.settimeout(seconds)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class ResilientGenerationClient:
    """Reconnect-and-retry wrapper over a :class:`GenerationClient`
    factory. A retryable failure (a server dead mid-frame, a connection
    refused during a restart, :class:`ServerBusyError` backpressure)
    backs off under the ``RetryPolicy`` and replays the request; a busy
    server keeps its connection, any other failure gets a new one.
    Generation is request/response, so a replay is safe without seqnos,
    and a fixed ``seed`` a request keeps the replayed stream the same.
    Each call salts the policy's jitter with its own count."""

    def __init__(self, make_client: Callable[[], GenerationClient],
                 policy=None):
        from distkeras_tpu_torch.resilience.retry import RetryPolicy

        self._make_client = make_client
        self.policy = policy if policy is not None else RetryPolicy()
        self._client = make_client()
        self.retries = 0
        self.reconnects = 0
        self._calls = 0

    def _reconnect(self, attempt: int, exc: BaseException) -> None:
        self.retries += 1
        if isinstance(exc, ServerBusyError):
            return      # healthy, just full: keep the connection
        self._client.close()
        try:
            self._client = self._make_client()
            self.reconnects += 1
        except Exception:  # noqa: BLE001
            pass        # still down: the next attempt fails fast, backs off

    def _run(self, fn):
        self._calls += 1
        return self.policy.run(fn, on_retry=self._reconnect,
                               salt=self._calls)

    def generate(self, prompt, **kw) -> np.ndarray:
        return self._run(lambda: self._client.generate(prompt, **kw))

    def stats(self) -> dict:
        return self._run(lambda: self._client.stats())

    def close(self) -> None:
        self._client.close()
