"""Retry policy and the reconnecting, commit-deduplicated PS client.

Port of ``distkeras_tpu/resilience/retry.py``:

- :class:`RetryPolicy`: exponential backoff with deterministic seeded
  jitter and a wall-clock deadline, and the retryable/fatal triage
  (``ProtocolError.retryable`` decides; other connection and socket
  errors are retryable; anything else is a bug and propagates at once).
- :class:`ResilientPSClient`: wraps any transport client factory (socket,
  shm, native, in-process) with reconnect-and-retry on pull, commit and
  exchange. Every commit carries a per-worker **sequence number** and the
  server folds a given (worker, seq) at most once, so the lost-ACK replay
  (the server folded, the reply died, the client retries) is refused as a
  duplicate instead of folded twice.

Heartbeats ride the training loop (``maybe_heartbeat`` at window
boundaries) rather than a thread of their own: nothing to leak, no second
connection, and liveness tracks the worker making progress.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable

import numpy as np

from distkeras_tpu_torch.networking import FencedEpochError, ProtocolError
from distkeras_tpu_torch.observability import trace as _trace

Pytree = Any


class RetryDeadlineExceeded(ConnectionError):
    """Retries exhausted (attempt budget or wall-clock deadline); carries
    the last underlying failure as ``__cause__``."""


def is_retryable(exc: BaseException) -> bool:
    """Transient transport weather vs a real bug.

    The failover triage, explicitly:

    - ``ConnectionRefusedError`` (ECONNREFUSED) and mid-handshake EOF ARE
      retryable: they are exactly what a client sees in the window
      between a primary dying and its replacement answering — backing
      off and re-resolving is the correct move, not dying.
    - ``ProtocolError`` carries its own verdict (an oversized frame will
      be oversized on every retry; a mid-frame close is weather).
    - ``FencedEpochError`` is a ProtocolError with ``retryable=False``:
      an epoch mismatch is deterministic against the same server. (The
      resilient client makes ONE exception — when its endpoint resolver
      has already moved to a newer epoch, the reconnect adopts it and
      the retry is legitimate; see ``ResilientPSClient._classify``.)
    - other connection/socket-level failures are retryable; everything
      else (shape errors, assertions) is a bug and propagates.
    """
    if isinstance(exc, ProtocolError):
        return exc.retryable
    return isinstance(exc, (ConnectionError, socket.timeout, BrokenPipeError,
                            EOFError, OSError))


class PSEndpoint:
    """Thread-safe record of where the CURRENT primary lives — host,
    port, and fencing epoch — shared by every worker's client factory
    and updated exactly once per failover by the trainer-side
    :class:`~distkeras_tpu_torch.resilience.recovery.PSFailoverSupervisor`.
    Reconnecting clients read it at connect time, so a reconnect after a
    promotion lands on the new primary carrying the new epoch with no
    per-worker coordination."""

    def __init__(self, host: str, port: int, epoch: int = 0):
        self._lock = threading.Lock()
        self._host = host
        self._port = int(port)
        self._epoch = int(epoch)
        self.updates = 0

    def resolve(self) -> tuple[str, int, int]:
        with self._lock:
            return self._host, self._port, self._epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def update(self, host: str, port: int, epoch: int) -> None:
        with self._lock:
            self._host = host
            self._port = int(port)
            self._epoch = int(epoch)
            self.updates += 1


class RetryPolicy:
    """Exponential backoff + deterministic jitter + deadline.

    Delay for attempt k (0-based) is ``base_delay * 2**k``, capped at
    ``max_delay``, each scaled by a seeded jitter factor drawn uniformly
    from ``[1 - jitter, 1]`` — full determinism given the seed, and
    jitter-down-only so the deadline math stays a guarantee. Retrying
    stops when ``max_attempts`` tries failed or the next sleep would land
    past ``deadline`` seconds from the first attempt.
    """

    def __init__(self, max_attempts: int = 6, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: float = 60.0,
                 jitter: float = 0.5, seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = float(deadline)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delays(self, salt: int = 0) -> "_DelaySequence":
        """A fresh deterministic delay sequence (one per retried call).
        ``salt`` decorrelates sequences that share a policy — without it,
        W workers backing off after one server death would retry in
        lockstep, preserving exactly the thundering herd jitter exists to
        break. Determinism holds per (seed, salt)."""
        return _DelaySequence(self, salt)

    def run(self, fn: Callable[[], Any], on_retry=None,
            clock=time.monotonic, sleep=time.sleep, salt: int = 0,
            classify: Callable[[BaseException], bool] | None = None) -> Any:
        """Call ``fn`` under this policy. ``on_retry(attempt, exc)`` fires
        before each re-attempt (the client uses it to reconnect and
        count). Non-retryable failures propagate untouched. ``classify``
        overrides the default :func:`is_retryable` triage (the resilient
        client widens it across failovers)."""
        triage = is_retryable if classify is None else classify
        t0 = clock()
        seq = self.delays(salt)
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:
                attempt += 1
                if not triage(e):
                    raise
                if attempt >= self.max_attempts:
                    raise RetryDeadlineExceeded(
                        f"gave up after {attempt} attempts: {e}"
                    ) from e
                delay = seq.next_delay()
                if clock() - t0 + delay > self.deadline:
                    raise RetryDeadlineExceeded(
                        f"deadline of {self.deadline}s exceeded after "
                        f"{attempt} attempts: {e}"
                    ) from e
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)


class _DelaySequence:
    """Deterministic jittered exponential-backoff delays for ONE call."""

    def __init__(self, policy: RetryPolicy, salt: int = 0):
        self._policy = policy
        self._rng = np.random.Generator(
            np.random.Philox([policy.seed, salt])
        )
        self._k = 0

    def next_delay(self) -> float:
        p = self._policy
        raw = min(p.base_delay * (2.0 ** self._k), p.max_delay)
        self._k += 1
        factor = 1.0 - p.jitter * float(self._rng.random())
        return raw * factor


class ResilientPSClient:
    """Reconnecting wrapper with seqno'd commits and piggyback heartbeats.

    ``make_client`` builds a fresh transport client (``pull`` / ``commit``
    / ``close``, optionally ``heartbeat``); the wrapper rebuilds it on a
    retryable failure and replays the op. A replayed commit re-sends the
    SAME sequence number, so the server's per-worker dedup keeps the fold
    exactly-once even when the original commit landed and only its ACK
    died. Exposes the same call surface the workers already use, so it
    drops into ``run_async_training`` transparently.
    """

    def __init__(self, make_client: Callable[[], Any], worker_id: int,
                 policy: RetryPolicy | None = None,
                 heartbeat_interval: float | None = None,
                 resolver: PSEndpoint | None = None):
        self._make_client = make_client
        self.worker_id = int(worker_id)
        self.policy = policy if policy is not None else RetryPolicy()
        self.heartbeat_interval = heartbeat_interval
        # Failover awareness: `resolver` names the current primary; the
        # factory is expected to read it, so every reconnect re-resolves
        # the endpoint and adopts the current fencing epoch. With a
        # resolver, a FencedEpochError is retried IFF the resolver has
        # moved past the epoch this client was using (the fence names a
        # failover we haven't caught up with); without one, fenced is
        # fatal — there is no newer endpoint to move to.
        self.resolver = resolver
        self._client = make_client()
        self.seq = 0           # logical commits CONFIRMED by this client
        self._wire_seq = 0     # seqnos issued (incl. abandoned commits)
        # Wire seqnos are epoch + seq: the epoch (wall-clock ns at client
        # birth) makes any new client's seqnos larger than any previous
        # client's for the same worker id — a fresh run against a
        # LONG-LIVED external PS must not have its seq 1..N silently
        # swallowed by the server's dedup fence from the previous run.
        # Dedup only needs per-worker monotonicity, not determinism.
        self._seq_epoch = time.time_ns()
        self.retries = 0       # cumulative reconnect-and-retry count
        self.reconnects = 0
        self._calls = 0        # jitter salt: decorrelates backoff per call
        self._timeout: float | None = None  # sticky across reconnects
        self._next_hb = 0.0    # piggyback rate limiter (monotonic)

    # -- plumbing ------------------------------------------------------------

    def _apply_timeout(self, client) -> None:
        if self._timeout is None:
            return
        if hasattr(client, "set_timeout"):
            client.set_timeout(self._timeout)
        elif hasattr(client, "_sock"):
            client._sock.settimeout(self._timeout)

    def _reconnect(self, attempt: int, exc: BaseException) -> None:
        self.retries += 1
        try:
            self._client.close()
        except Exception:
            pass
        try:
            self._client = self._make_client()
            self.reconnects += 1
            # the bound must survive the swap: transports default to
            # block-forever, which would defeat a caller's deadline
            self._apply_timeout(self._client)
        except Exception:
            # server still down: keep the dead client; the next retry's
            # op fails fast and lands back here after one more backoff
            pass

    def _classify(self, exc: BaseException) -> bool:
        if isinstance(exc, FencedEpochError) and self.resolver is not None:
            # A fence names a failover; with a resolver every reconnect
            # re-resolves and adopts the CURRENT epoch, so retrying is
            # how this client catches up. Deliberately retryable even
            # when the resolver hasn't advanced yet — promotion updates
            # it moments after the fence lands, and racing that window
            # with a fatal would kill workers the failover was built to
            # save. A resolver that never advances ends the loop at the
            # retry deadline instead. Without a resolver there is no
            # newer endpoint to move to: fenced stays fatal.
            return True
        return is_retryable(exc)

    def _run(self, fn: Callable[[], Any]) -> Any:
        self._calls += 1
        salt = (self.worker_id << 32) ^ self._calls
        return self.policy.run(fn, on_retry=self._reconnect, salt=salt,
                               classify=self._classify)

    # -- the worker-facing surface -------------------------------------------

    def pull(self, worker_id: int | None = None) -> Pytree:
        return self._run(lambda: self._client.pull())

    def commit(self, worker_id: int | None, payload: Pytree) -> None:
        # ONE seqno per logical commit, assigned before the first attempt;
        # every replay re-sends it, so the server folds it at most once.
        # `seq` counts only CONFIRMED commits (an ack, fresh or dup, came
        # back): a commit abandoned at the retry deadline must not inflate
        # the exactly-once oracle's logical count. The one residual
        # ambiguity is inherent to at-least-once delivery: an abandoned
        # commit whose very first attempt folded server-side before the
        # ack died leaves commits == logical + 1 — possible only in runs
        # that lost a worker mid-commit, which the oracle's consumers
        # (the chaos tests and the chip smoke) don't tolerate silently.
        self._wire_seq += 1
        seq = self._seq_epoch + self._wire_seq
        if _trace.enabled():
            # the seqno IS the wire-carried correlation id: stamp it on
            # this thread so the worker-side exchange span and the
            # server-side fold/WAL spans (Python frame corr, or the
            # native ring's (wid, seq)) close under one id
            _trace.set_corr(f"w{self.worker_id}:s{seq}")
        self._run(lambda: self._client.commit(self.worker_id, payload,
                                              seq=seq))
        self.seq += 1

    def exchange(self, worker_id: int | None, payload: Pytree,
                 lag: bool = False) -> Pytree:
        """Fused commit + pull under the retry policy: ONE
        seqno covers the whole exchange — a lost-ACK replay re-sends the
        same seq, the server's dedup skips the re-fold but still answers
        with a fresh center (the pull half retries like any pull), so the
        fused action is exactly-once for the fold and at-least-once for
        the read, which is precisely the ``commit(); pull()`` contract.
        Transports without a fused channel fall back to the 2-RTT pair
        inside one retried op (a replayed pair dedups its commit)."""
        self._wire_seq += 1
        seq = self._seq_epoch + self._wire_seq
        if _trace.enabled():
            _trace.set_corr(f"w{self.worker_id}:s{seq}")  # see commit()

        def op():
            inner = self._client
            ex = getattr(inner, "exchange", None)
            if ex is not None:
                return ex(self.worker_id, payload, seq=seq, lag=lag)
            inner.commit(self.worker_id, payload, seq=seq)
            return inner.pull()

        out = self._run(op)
        self.seq += 1
        return out

    def heartbeat(self, retries: int | None = None) -> None:
        """Renew this worker's lease now (reporting cumulative retries)."""
        n = self.retries if retries is None else int(retries)
        self._run(lambda: self._client.heartbeat(retries=n))

    def maybe_heartbeat(self) -> bool:
        """Piggyback hook for the training loop: renew at most once per
        ``heartbeat_interval`` (no-op when the interval is None). Returns
        whether a heartbeat was sent. Never raises on transport failure —
        liveness reporting must not kill a worker the lease would merely
        have expired."""
        if self.heartbeat_interval is None:
            return False
        now = time.monotonic()
        if now < self._next_hb:
            return False
        self._next_hb = now + float(self.heartbeat_interval)
        try:
            self.heartbeat()
        except Exception:
            return False
        return True

    def join(self) -> dict | None:
        """Elastic live-join admission (``ROADMAP.md`` A7.8), under the
        retry policy. Returns the server's admission record, or None when
        the transport has no join channel (the lease then starts with the
        first heartbeat)."""
        def op():
            inner = self._client
            join = getattr(inner, "join", None)
            return None if join is None else join()

        return self._run(op)

    def drain(self, timeout: bool = False) -> None:
        """Preemption drain (``ROADMAP.md`` A7.8: a clean deregister and
        the server's elastic counters), under the retry policy. Falls back
        to a plain deregister on transports without a drain channel."""
        def op():
            inner = self._client
            drain = getattr(inner, "drain", None)
            if drain is not None:
                return drain(timeout=timeout)
            dereg = getattr(inner, "deregister", None)
            if dereg is not None:
                dereg()

        self._run(op)

    def shard_map(self) -> dict | None:
        """Forward the shard-map handshake (sharding, ``ROADMAP.md`` A7.7)
        to the wrapped transport client, under the retry policy. Returns
        None when the inner transport has no shard channel (the port's
        servers answer the action with an error frame naming A7.7)."""
        def op():
            # re-resolve per attempt: a retry's reconnect swaps _client
            inner = self._client
            probe = (getattr(inner, "shard_map", None)
                     or getattr(inner, "shard_info", None))
            return None if probe is None else probe()

        return self._run(op)

    def set_timeout(self, seconds: float | None) -> None:
        """Bound the inner client's round-trips (transport-appropriate);
        sticky — re-applied to every replacement client a reconnect
        builds, so the bound survives retries."""
        self._timeout = seconds
        self._apply_timeout(self._client)

    def close(self) -> None:
        try:
            if hasattr(self._client, "deregister"):
                self._client.deregister()
        except Exception:
            pass
        self._client.close()
