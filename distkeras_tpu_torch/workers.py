"""Asynchronous workers: hogwild replicas driving the card from host threads.

Port of ``distkeras_tpu/workers.py`` (``AsyncWorker``,
``run_async_training``, ``aggregate_exchange_phases``, ``_BoundPS``) for a
fixed pool of workers over the in-process, socket, shared-memory (``shm``)
or native transport. Each worker
is a host thread that pulls the center, runs ``communication_window``
local steps on the card (``torch.func.grad_and_value`` of the trainer's
loss step, then the optimizer: K5 for ``fused_adam``, and K6/K7 inside an
LSTM's forward and backward), then commits — free-running against the
other workers, like the reference.

What a worker commits (the reference's payloads):

- ADAG / DOWNPOUR / DynSGD: the window's weight delta against the pulled
  center, computed on the host after one copy of the params off the card;
  the worker re-bases onto the fresh post-fold center (one fused
  ``exchange`` round trip by default).
- AEASGD / EAMSGD: the elastic difference ``alpha · (worker − center)``
  against a freshly pulled center; the worker subtracts the transmitted
  difference from itself and keeps its own variable.

With ``ps_pipeline_depth=1`` the delta rules pipeline: a worker launches
window N+1 on the card, then exchanges window N on the host while the card
runs (the elastic rules keep the serial loop: their commit needs a fresh
pull). Window N+1 starts from ``C_{N-1} + sent_N``, the freshest center in
hand plus this window's own transmitted update, and exchange N carries
``lag=True`` so DynSGD prices the extra window of staleness. The loop reads
nothing off the card between launching window N+1 and finishing exchange
N: window N's loss came to the host with its params, before N+1 launched.

Every worker runs on the trainer's one device, each launching its own
kernels (``G = 1``) on the current stream; placing workers across cards is
``ROADMAP.md`` A12. Every host→device copy is a real copy, so a worker's
params never share memory with a PS snapshot or a staging buffer.

The resilience layer (``resilience/``) hooks in here as in the reference:
a ``FaultPlan`` kills or slows a worker at a window boundary; a retry
policy or a heartbeat interval wraps every client in a
``ResilientPSClient`` (reconnects, seqno'd commits the server folds once,
leases renewed at window boundaries); ``worker_restart_budget`` runs the
workers under a ``WorkerSupervisor``, which restarts a dead one from a
fresh center pull in a new thread (a fresh per-thread module and a fresh
optimizer state: nothing it held on the card is reused); ``ps_wal_dir``
makes the server durable; and on the socket transport ``ps_standby`` or a
PS-kill fault starts a ``PSFailoverSupervisor`` that promotes the hot
standby, or restarts the server in place from its WAL, and repoints every
client. ``trainer.resilience_stats_`` reports the exactly-once oracle
(``logical_commits``, to hold against the server's folds), retries,
reconnects, restarts, the injected faults and the failover log.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch

from distkeras_tpu_torch import utils
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.parallel.compression import (
    Int8Codec,
    maybe_decode,
    resolve_codec,
    validate_pull_compression,
)
from distkeras_tpu_torch.parallel.merge_rules import ElasticAverageMerge
from distkeras_tpu_torch.parameter_servers import (
    ParameterServer,
    ParameterServerClient,
    SocketParameterServer,
    StandbySocketParameterServer,
)
from distkeras_tpu_torch.utils import tree_map

Tree = Any

#: a worker thread that finishes no window for the longer of
#: ``_STALL_FLOOR_S`` and ``_STALL_WINDOWS`` times its slowest window so far
#: is stuck (a fold wait or a call on the card that never returns): the
#: trainer stops waiting for it and raises
_STALL_FLOOR_S = 300.0
_STALL_WINDOWS = 20
_JOIN_SLICE_S = 0.5

#: exchange-phase histogram bucket edges (ms, powers of two), with one
#: overflow bucket past the last edge
_PHASE_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                  128.0, 256.0, 512.0, 1024.0)


def aggregate_exchange_phases(workers) -> dict:
    """Merge every worker's per-phase exchange timings (fetch / compress /
    commit / pull, and the window's compute on the card, in ms) into one
    JSON-clean summary: ``trainer.ps_stats_["exchange_phases"]``."""
    out: dict = {}
    for w in workers:
        for name, rec in getattr(w, "_phases", {}).items():
            agg = out.setdefault(name, {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                "hist_ms_le": list(_PHASE_BUCKETS) + ["inf"],
                "hist": [0] * (len(_PHASE_BUCKETS) + 1),
            })
            agg["count"] += rec["count"]
            agg["total_ms"] += rec["total_ms"]
            agg["max_ms"] = max(agg["max_ms"], rec["max_ms"])
            agg["hist"] = [a + b for a, b in zip(agg["hist"], rec["hist"])]
    for rec in out.values():
        rec["mean_ms"] = (rec["total_ms"] / rec["count"] if rec["count"]
                          else 0.0)
    return out


def _stack1(tree):
    return tree_map(lambda x: x[None], tree)


def _build_local_window(loss_step, optimizer):
    """One worker's window: ``window`` local steps of
    ``grad_and_value(loss_step)`` and the optimizer, no vmap. The port's
    optimizers take worker-stacked trees (global-norm clipping reduces per
    worker), so a worker is a stack of one for the optimizer: its state
    holds ``[1, …]`` leaves (``init_opt``)."""
    grad_fn = torch.func.grad_and_value(loss_step, has_aux=True)

    def window(params, nt, opt, batches):
        losses = []
        for k in range(batches[0].shape[0]):
            grads, (loss, nt) = grad_fn(params, nt,
                                        tuple(b[k] for b in batches))
            updates, opt = optimizer.update(_stack1(grads), opt,
                                            _stack1(params))
            params = tree_map(lambda p, u: p + u[0].to(p.dtype), params,
                              updates)
            losses.append(loss)
        return params, nt, opt, torch.stack(losses).mean()

    def init_opt(params):
        return optimizer.init(_stack1(params))

    window.init_opt = init_opt
    return window


def _to_device(tree, device):
    """Host numpy tree → tensors on ``device``, always a copy."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


class AsyncWorker:
    """One training replica on the card, exchanging with the PS."""

    def __init__(self, worker_id: int, device, window_fn, ps, rule,
                 window: int, batch_size: int, nt, history: list,
                 lock: threading.Lock, codec=None, fused: bool = True,
                 pipeline_depth: int = 0, fault_plan=None):
        self.worker_id = worker_id
        self.device = device
        self.window_fn = window_fn
        self.ps = ps
        self.rule = rule
        self.window = window
        self.batch_size = batch_size
        self.nt = nt
        self.history = history
        self.lock = lock
        # lossy commit compression with error feedback: what the codec
        # dropped is added to the next window's commit
        self.codec = codec
        self._resid = None
        # fused: commit + pull in one EXCHANGE round trip (delta rules)
        self.fused = bool(fused)
        # ps_pipeline_depth: 1 runs the pipelined loop (delta rules only)
        self.pipeline_depth = int(pipeline_depth)
        self.error: BaseException | None = None
        # the fault plan's kill and straggle hooks fire at each window,
        # keyed on this worker's windows so far (a restart keeps counting)
        self.fault_plan = fault_plan
        self._windows_done = 0
        # the WorkerSupervisor's restore state: checkpoints are ROADMAP.md
        # A8, so a restart always starts from a fresh center pull
        self.snapshot: dict | None = None
        self.restore: dict | None = None
        self.start_epoch = 0
        self.barrier = None
        self.running = False
        self._stage_delta: list | None = None
        # the pipelined re-base's two alternating staging sets
        self._stage_base: list | None = None
        self._base_flip = 0
        self._phases: dict[str, dict] = {}
        self._xid = 0
        # the trainer's stall watch: when this worker last finished a
        # window (or started), and its longest window so far (seconds)
        self.progress_t = time.monotonic()
        self.slowest_s = 0.0

    def _compress(self, tree, owned: bool = False):
        """→ (wire payload, transmitted tree), updating the residual in
        place. ``owned=True`` lets the residual add write into ``tree``
        (this worker's staging buffers)."""
        if self.codec is None:
            return tree, tree
        if self._resid is not None:
            add = (lambda t, r: np.add(t, r, out=t)) if owned else np.add
            tree = utils.host_tree_map(add, tree, self._resid)
        blob = self.codec.encode(tree)
        sent = self.codec.decode(blob)
        if self._resid is None:
            self._resid = utils.host_tree_map(np.subtract, tree, sent)
        else:
            utils.host_tree_map(lambda r, t, s: np.subtract(t, s, out=r),
                                self._resid, tree, sent)
        return blob, sent

    def _phase(self, name: str, t0: float) -> float:
        """Record one exchange-phase sample (ms since ``t0``, a span too
        when tracing); returns a fresh ``perf_counter`` for the next."""
        t1 = time.perf_counter()
        if _trace.enabled():
            _trace.record("worker." + name, int(t0 * 1e9), int(t1 * 1e9))
        ms = (t1 - t0) * 1e3
        rec = self._phases.get(name)
        if rec is None:
            rec = self._phases[name] = {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                "hist": [0] * (len(_PHASE_BUCKETS) + 1)}
        rec["count"] += 1
        rec["total_ms"] += ms
        rec["max_ms"] = max(rec["max_ms"], ms)
        rec["hist"][bisect.bisect_left(_PHASE_BUCKETS, ms)] += 1
        return t1

    def _window_delta(self, params, base):
        """``params − base`` on the host: one copy of the params off the
        card (the ``fetch`` phase), then an f32 numpy subtract into staging
        buffers allocated once, as the reference computes it."""
        hleaves = utils.flatten(utils.tree_to_numpy(params))[0]
        cleaves, structure = utils.flatten(base)
        if self._stage_delta is None:
            self._stage_delta = [np.empty(h.shape, h.dtype) for h in hleaves]
        out = [np.subtract(h, np.asarray(c), out=s)
               for h, c, s in zip(hleaves, cleaves, self._stage_delta)]
        return utils.unflatten(structure, out)

    def _rebase_host(self, center, sent):
        """The pipelined re-base ``center + sent`` into one of two
        alternating staging sets: the set window N's params were copied
        from is rewritten only at window N+2, so nothing can overwrite a
        buffer a transfer may still read."""
        cleaves, structure = utils.flatten(center)
        sleaves = utils.flatten(sent)[0]
        if self._stage_base is None:
            self._stage_base = [[np.empty(np.shape(c), np.asarray(c).dtype)
                                 for c in cleaves] for _ in range(2)]
        bufs = self._stage_base[self._base_flip]
        self._base_flip ^= 1
        out = [np.add(np.asarray(c), np.asarray(s), out=b)
               for c, s, b in zip(cleaves, sleaves, bufs)]
        return utils.unflatten(structure, out)

    def _do_exchange(self, blob, lag: bool = False):
        """One exchange: the fused round trip when enabled and the client
        speaks it (its time lands in ``commit``), else commit then pull.
        Only the fused exchange carries ``lag`` (the trainer refuses the
        pipeline without it)."""
        t0 = time.perf_counter()
        exchange = getattr(self.ps, "exchange", None) if self.fused else None
        if exchange is not None:
            center = exchange(self.worker_id, blob, lag=lag)
            self._phase("commit", t0)
        else:
            self.ps.commit(self.worker_id, blob)
            t0 = self._phase("commit", t0)
            center = self.ps.pull(self.worker_id)
            self._phase("pull", t0)
        return center

    def train(self, index: int, shard_cols: tuple, num_epoch: int,
              shuffle: bool, seed: int) -> None:
        """The reference's ``Worker.train(index, iterator)``; a failure is
        kept on ``self.error`` for the trainer (and its supervisor)."""
        self.running = True
        self.progress_t = time.monotonic()
        try:
            self._train(index, shard_cols, num_epoch, shuffle, seed)
        except BaseException as e:
            self.error = e
        finally:
            self.running = False

    def _train(self, index, shard_cols, num_epoch, shuffle, seed):
        """The window loop. A delta rule's window ends in a pending
        exchange: at depth 0 it is flushed before the next window
        launches, at depth 1 just after (window N's exchange runs on the
        host while window N+1 runs on the card, and N+1 starts from
        ``C_{N-1} + sent_N``). ``compute`` spans a window's launch to its
        loss on the host, so at depth 1 it contains the previous window's
        exchange. An elastic rule's commit needs a fresh pull, so it cannot
        be deferred: it always exchanges serially."""
        if self.restore is not None:
            raise NotImplementedError(
                "restoring a worker from a checkpoint is not ported yet: "
                "ROADMAP.md A8 (checkpoints and EMA)")
        rows = len(shard_cols[0])
        win_rows = self.window * self.batch_size
        n_windows = rows // win_rows
        elastic = isinstance(self.rule, ElasticAverageMerge)
        pipelined = self.pipeline_depth >= 1 and not elastic
        # the lease: registered up front (a restarted worker's first
        # heartbeat re-admits it after an eviction), renewed each window
        maybe_heartbeat = getattr(self.ps, "maybe_heartbeat", None)
        if maybe_heartbeat is not None:
            maybe_heartbeat()
        center = self.ps.pull(self.worker_id)
        params = _to_device(center, self.device)
        base = center          # the window's start, on the host
        nt = _to_device(self.nt, self.device)
        opt = self.window_fn.init_opt(params)
        pending = None         # window N's (blob, loss, epoch, corr)
        for epoch in range(self.start_epoch, num_epoch):
            order = (np.random.default_rng((seed, index, epoch))
                     .permutation(rows) if shuffle else np.arange(rows))
            for w in range(n_windows):
                if self.fault_plan is not None:
                    # chaos: a kill at this worker's window (once; its
                    # restart passes the same index unharmed), a straggler
                    # sleeps here every window
                    self.fault_plan.maybe_kill(self.worker_id,
                                               self._windows_done)
                    self.fault_plan.maybe_straggle(self.worker_id)
                batches = self._batches(
                    shard_cols, order[w * win_rows:(w + 1) * win_rows])
                t_launch = time.perf_counter()
                params, nt, opt, loss = self.window_fn(params, nt, opt,
                                                       batches)
                if pending is not None:
                    center = self._flush(pending, lag=True)
                    pending = None
                if _trace.enabled():
                    self._xid += 1
                    _trace.set_corr(f"w{self.worker_id}:x{self._xid}")
                loss = float(loss)   # waits for this window on the card
                t0 = self._phase("compute", t_launch)
                if elastic:
                    params, center = self._elastic_exchange(params, t0)
                    self._window_done(loss, epoch)
                    self._windows_done += 1
                    if maybe_heartbeat is not None:
                        maybe_heartbeat()
                    continue
                delta = self._window_delta(params, base)
                t0 = self._phase("fetch", t0)
                blob, sent = self._compress(delta, owned=True)
                self._phase("compress", t0)
                pending = (blob, loss, epoch,
                           _trace.current_corr() if _trace.enabled()
                           else None)
                if pipelined:
                    base = self._rebase_host(center, sent)
                else:
                    center = base = self._flush(pending)
                    pending = None
                params = _to_device(base, self.device)
                self._windows_done += 1
                if maybe_heartbeat is not None:
                    maybe_heartbeat()  # rate-limited lease renewal
        if pending is not None:
            self._flush(pending, lag=True)   # the last window's exchange
        self.final_nt = utils.tree_to_numpy(nt)

    def _batches(self, shard_cols, sl):
        return tuple(torch.as_tensor(c[sl].reshape(
            (self.window, self.batch_size) + c.shape[1:])).to(self.device)
            for c in shard_cols)

    def _elastic_exchange(self, params, t0: float):
        """An elastic rule's exchange: a fresh center at exchange time
        (EASGD), the elastic difference committed, and the worker moved by
        the transmitted difference (symmetric under lossy compression).
        The commit depends on the pull, so it cannot be fused. Returns the
        moved ``(params, center)``."""
        center = self.ps.pull(self.worker_id)
        t0 = self._phase("pull", t0)
        host_params = utils.tree_to_numpy(params)
        t0 = self._phase("fetch", t0)
        diff = self.rule.worker_commit(host_params, center)
        blob, sent = self._compress(diff)
        t0 = self._phase("compress", t0)
        self.ps.commit(self.worker_id, blob)
        self._phase("commit", t0)
        params = _to_device(
            tree_map(lambda p, d: p - d, host_params, sent), self.device)
        return params, center

    def _flush(self, pending, lag: bool = False):
        """Exchange one window's commit (``lag=True`` when it was deferred
        behind the next window); its history row lands when its exchange
        completes. Returns the fresh center."""
        blob, loss, epoch, corr = pending
        if corr is not None:
            _trace.set_corr(corr)
        center = self._do_exchange(blob, lag=lag)
        self._window_done(loss, epoch)
        return center

    def _window_done(self, loss: float, epoch: int) -> None:
        """A window's exchange completed: its history row, and the stall
        watch's progress mark."""
        with self.lock:
            self.history.append({"loss": loss, "epoch": epoch,
                                 "worker": self.worker_id})
        now = time.monotonic()
        self.slowest_s = max(self.slowest_s, now - self.progress_t)
        self.progress_t = now


class _BoundPS:
    """In-process client: binds a worker id to the shared PS object.
    ``pull_compression="int8"`` still round-trips the int8 encode and
    decode, so the in-process transport stays the socket's oracle."""

    def __init__(self, ps: ParameterServer, worker_id: int,
                 pull_compression: str | None = None,
                 epoch: int | None = None):
        self._ps = ps
        self.worker_id = worker_id
        self.pull_compression = validate_pull_compression(pull_compression)
        self.epoch = None if epoch is None else int(epoch)

    def pull(self, worker_id: int | None = None):
        if self.pull_compression == "int8":
            return maybe_decode(self._ps.pull(self.worker_id,
                                              compressed=True))
        return self._ps.pull(self.worker_id)

    def commit(self, worker_id: int | None, payload, seq: int | None = None):
        self._ps.commit(self.worker_id, payload, seq=seq, epoch=self.epoch)

    def exchange(self, worker_id: int | None, payload,
                 seq: int | None = None, lag: bool = False):
        blob, _applied = self._ps.exchange(
            self.worker_id, payload, seq=seq, epoch=self.epoch, lag=lag,
            compressed=self.pull_compression == "int8")
        return maybe_decode(blob)

    def heartbeat(self, retries: int = 0) -> bool:
        return self._ps.heartbeat(self.worker_id, retries=retries)

    def deregister(self) -> None:
        self._ps.deregister_worker(self.worker_id)

    def close(self):
        pass


def _join_workers(threads, workers) -> None:
    """Join each thread in bounded slices, paired with a worker (the
    workers' own threads, or the supervisor's thread once per worker). A
    worker still running whose last window ended longer ago than its
    stall limit raises ``TimeoutError`` naming it; the daemon threads are
    left behind, and the caller's ``finally`` closes the clients and
    stops the PS."""
    pending = list(zip(threads, workers))
    while pending:
        pending[0][0].join(timeout=_JOIN_SLICE_S)
        pending = [(t, w) for t, w in pending if t.is_alive()]
        now = time.monotonic()
        for t, w in pending:
            if not getattr(w, "running", True):
                continue
            limit = max(_STALL_FLOOR_S, _STALL_WINDOWS * w.slowest_s)
            if now - w.progress_t > limit:
                raise TimeoutError(
                    f"PS worker {w.worker_id} ({t.name}) finished no window "
                    f"in {limit:.0f} s: stuck in an exchange or on the "
                    f"device")


def _ps_kwargs(trainer, lease_timeout) -> dict:
    """The resilience arguments every Python server takes."""
    return dict(lease_timeout=lease_timeout, wal_dir=trainer.ps_wal_dir,
                snapshot_every=trainer.ps_snapshot_every,
                wal_group_window=trainer.ps_wal_group_window,
                wal_group_interval=trainer.ps_wal_group_interval)


def _resilience_stats(clients, supervisor, fault_plan, ps_supervisor):
    """``trainer.resilience_stats_``: the commit-seqno oracle (logical
    commits the clients saw acknowledged, to hold against the server's
    folds), retry and reconnect totals, supervisor restarts, what the
    fault plan injected and the failover log."""
    return {
        "logical_commits": sum(int(getattr(c, "seq", 0)) for c in clients),
        "retries": sum(int(getattr(c, "retries", 0)) for c in clients),
        "reconnects": sum(int(getattr(c, "reconnects", 0)) for c in clients),
        "restarts": supervisor.stats()["restarts"] if supervisor else 0,
        "faults": fault_plan.stats() if fault_plan is not None else None,
        "ps_failover": (ps_supervisor.stats() if ps_supervisor is not None
                        else None),
    }


def run_async_training(trainer, ds, shuffle: bool):
    """Drive the PS backend for a ``DistributedTrainer`` (the reference's
    ``mapPartitionsWithIndex(worker.train).collect()`` job): start the PS
    (or reach the external one at ``ps_host``), run ``num_workers`` worker
    threads over their row shards, and return ``(center, nt, history)``
    with the center as host numpy. Sets ``trainer.ps_stats_`` (the active
    server's ``stats()`` plus ``exchange_phases``; None for an external
    PS; after a failover its op counters start at the takeover, while
    ``num_updates`` spans the run), ``trainer.resilience_stats_`` (with
    any resilience knob or fault plan; else None),
    ``trainer.exchange_phases_`` (this process's workers' phases, on every
    transport) and ``trainer.trace_path_``."""
    from distkeras_tpu_torch.resilience.recovery import WorkerSupervisor
    from distkeras_tpu_torch.resilience.retry import (
        PSEndpoint,
        ResilientPSClient,
        RetryPolicy,
    )

    spec = trainer.spec
    rule = trainer.allocate_merge_rule()
    params, nt = spec.init_np(trainer.seed)
    W = trainer.num_workers
    transport = trainer.ps_transport
    external_host = trainer.ps_host
    offset = int(trainer.worker_id_offset)
    codec = resolve_codec(trainer.compression)
    pull_comp = trainer.pull_compression
    if codec is not None and transport == "native":
        # the trainer admits only the stock Int8Codec here; every float
        # leaf rides the segmented wire: its flat frame has no raw
        # passthrough for small leaves
        codec = Int8Codec(min_size=1)

    # the resilience knobs: a retry policy or a heartbeat interval turns
    # the transport clients into reconnecting, seqno'd, lease-renewing
    # wrappers
    retry_policy = trainer.retry_policy
    hb_interval = trainer.heartbeat_interval
    resilient = retry_policy is not None or hb_interval is not None
    lease_timeout = trainer.lease_timeout
    if lease_timeout is None and hb_interval is not None:
        lease_timeout = 5.0 * float(hb_interval)  # five missed heartbeats
    fault_plan = trainer.fault_plan
    if fault_plan is not None and getattr(fault_plan, "has_elastic_events",
                                          False):
        raise ValueError(
            "fault_plan carries join/preempt membership events but the "
            "trainer is not elastic (elastic membership is not ported yet: "
            "ROADMAP.md A7.8); a fixed-pool run never consults them, so "
            "the chaos would silently test nothing")
    failover_timeout = trainer.ps_failover_timeout
    if failover_timeout is None:
        failover_timeout = lease_timeout if lease_timeout is not None \
            else 2.0
    kill_ps_chaos = (fault_plan is not None and getattr(
        fault_plan, "kill_ps_after_commits", None) is not None)
    failover = transport == "socket" and external_host is None and (
        trainer.ps_standby or kill_ps_chaos)
    if failover and retry_policy is None:
        # a failover is survivable only through reconnecting clients, and
        # the default policy's 6 attempts span ~1.5 s, less than detecting
        # and promoting: budget for the failover with room to spare
        resilient = True
        retry_policy = RetryPolicy(
            max_attempts=100, base_delay=0.05, max_delay=0.5,
            deadline=max(60.0, 20.0 * float(failover_timeout)))
    if resilient and transport == "native" and codec is not None:
        raise ValueError(
            "ps_transport='native' carries commit seqnos on the raw f32 "
            "wire only: drop compression or use ps_transport='socket' when "
            "retry_policy/heartbeat_interval are set")

    trace_dir = trainer.trace_dir
    trace_on = bool(trainer.trace) or trace_dir is not None
    trace_owner = trace_on and not _trace.enabled()
    if trace_owner:
        _trace.enable(sample=float(trainer.trace_sample))
    trainer.trace_path_ = None
    trainer.ps_stats_ = None
    trainer.resilience_stats_ = None

    ps = None
    resolver = None
    standby = None
    ps_supervisor = None
    if external_host is not None and transport == "native":
        from distkeras_tpu_torch.native_ps import FlatSpec, NativePSClient

        flat_spec = FlatSpec(params)

        def make_client(i):
            return NativePSClient(external_host, int(trainer.ps_port),
                                  offset + i, flat_spec,
                                  pull_compression=pull_comp)
    elif external_host is not None:
        def make_client(i):
            return ParameterServerClient(external_host, int(trainer.ps_port),
                                         offset + i,
                                         pull_compression=pull_comp)
    elif transport == "native":
        from distkeras_tpu_torch.native_ps import (
            NativePSClient,
            NativeSocketParameterServer,
        )

        ps = NativeSocketParameterServer(params, rule, W,
                                         port=trainer.ps_port,
                                         **_ps_kwargs(trainer, lease_timeout))
        ps.initialize()
        ps.start()

        def make_client(i):
            return NativePSClient("127.0.0.1", ps.port, i, ps.spec,
                                  pull_compression=pull_comp)
    elif transport == "shm":
        from distkeras_tpu_torch.shm import ShmParameterServer, ShmPSClient

        ps = ShmParameterServer(params, rule, W,
                                **_ps_kwargs(trainer, lease_timeout))
        ps.initialize()
        ps.start()

        def make_client(i):
            return ShmPSClient(ps, i, pull_compression=pull_comp)
    elif transport == "socket":
        ps = SocketParameterServer(params, rule, W, port=trainer.ps_port,
                                   **_ps_kwargs(trainer, lease_timeout))
        ps.initialize()
        ps.start()
        if failover:
            # clients resolve the CURRENT primary (host, port, fencing
            # epoch) at every connect, so a promotion repoints every
            # reconnect
            resolver = PSEndpoint("127.0.0.1", ps.port,
                                  epoch=ps.fence_epoch)

            def make_client(i):
                host, port, epoch = resolver.resolve()
                return ParameterServerClient(host, port, i,
                                             pull_compression=pull_comp,
                                             epoch=epoch)
        else:
            def make_client(i):
                return ParameterServerClient("127.0.0.1", ps.port, i,
                                             pull_compression=pull_comp)
    elif transport == "inprocess":
        ps = ParameterServer(params, rule, W,
                             **_ps_kwargs(trainer, lease_timeout))

        def make_client(i):
            return _BoundPS(ps, i, pull_compression=pull_comp)
    else:
        raise ValueError(f"unknown ps_transport {transport!r}")

    clients: list = []
    workers: list = []
    supervisor = None
    try:
        if failover:
            standby, ps_supervisor = _start_failover(
                trainer, ps, params, rule, W, lease_timeout, resolver,
                fault_plan if kill_ps_chaos else None, failover_timeout)

        def build_client(i):
            if not resilient:
                return make_client(i)
            return ResilientPSClient(lambda: make_client(i), offset + i,
                                     policy=retry_policy,
                                     heartbeat_interval=hb_interval,
                                     resolver=resolver)

        clients = [build_client(i) for i in range(W)]
        cols = trainer.features_col + [trainer.label_col]
        shards = ds.worker_shards(
            W, trainer.batch_size, trainer.communication_window, cols,
            seed=trainer.seed if shuffle else None, cover_all=shuffle)
        window_fn = _build_local_window(trainer._loss_step(),
                                        trainer.allocate_optimizer())
        history: list[dict] = []
        hlock = threading.Lock()
        workers = [AsyncWorker(i, trainer.device, window_fn, clients[i], rule,
                               trainer.communication_window,
                               trainer.batch_size, nt, history, hlock,
                               codec=codec, fused=trainer.ps_fused_exchange,
                               pipeline_depth=trainer.ps_pipeline_depth,
                               fault_plan=fault_plan)
                   for i in range(W)]

        def args_of(i):
            return (i, tuple(col[i] for col in shards), trainer.num_epoch,
                    shuffle, trainer.seed)

        budget = int(trainer.worker_restart_budget)
        if budget > 0:
            # restart-with-budget: a dead worker relaunches (in a new
            # thread, from a fresh center pull) up to `budget` times;
            # checkpoints are ROADMAP.md A8, so there is nothing to
            # restore from
            supervisor = WorkerSupervisor(
                workers, args_of, max_restarts=budget,
                restart_delay=trainer.worker_restart_delay,
                fallback_restore=lambda i: None)
            runner = threading.Thread(target=supervisor.run, daemon=True,
                                      name="distkeras-worker-supervisor")
            runner.start()
            _join_workers([runner] * W, workers)
        else:
            threads = [threading.Thread(
                target=w.train, daemon=True, name=f"distkeras-worker-{i}",
                args=args_of(i)) for i, w in enumerate(workers)]
            for t in threads:
                t.start()
            _join_workers(threads, workers)

        # training is over: retire the failover supervisor FIRST (it must
        # not declare a primary dead because it was stopped), then read
        # which server holds the final center
        active = ps
        if ps_supervisor is not None:
            ps_supervisor.stop()
            active = ps_supervisor.active
            if ps_supervisor.error is not None and not any(
                    w.error is not None for w in workers):
                raise RuntimeError(
                    "the PS failover supervisor died while the workers "
                    "survived") from ps_supervisor.error
        if (resilient or supervisor is not None
                or fault_plan is not None):
            trainer.resilience_stats_ = _resilience_stats(
                clients, supervisor, fault_plan, ps_supervisor)
        _raise_worker_errors(trainer, workers, supervisor, budget)
        trainer.exchange_phases_ = aggregate_exchange_phases(workers)
        if ps is None:
            # the external PS owns the center: a last snapshot over the wire
            clients[0].set_timeout(60.0)
            center = clients[0].pull()
        else:
            for c in clients:
                c.close()  # a resilient close deregisters its worker
            clients = []
            center = active.get_model()
            trainer.ps_stats_ = active.stats()
            trainer.ps_stats_["exchange_phases"] = trainer.exchange_phases_
        if trace_dir is not None:
            trainer.trace_path_ = _trace.save(os.path.join(
                trace_dir, f"ps-trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        if ps_supervisor is not None:
            ps_supervisor.stop()
        for c in clients:
            c.close()
        for server in {id(x): x for x in (
                ps, standby,
                ps_supervisor.active if ps_supervisor else None)
                if x is not None}.values():
            server.stop()
        if trace_owner:
            _trace.disable()
    final_nt = next((w.final_nt for w in workers if hasattr(w, "final_nt")),
                    nt)
    return center, final_nt, history


def _start_failover(trainer, ps, params, rule, W, lease_timeout, resolver,
                    kill_plan, failover_timeout):
    """The socket transport's failover wiring: the hot standby (with
    ``ps_standby``; its WAL under ``<ps_wal_dir>/standby``) attached to the
    primary, a restart-in-place factory (with ``ps_wal_dir``), the PS-kill
    chaos hook in the commit path (deterministic in commit count, tearing
    in-flight ACKs like a real kill), and the started supervisor. Returns
    ``(standby or None, supervisor)``."""
    from distkeras_tpu_torch.resilience.recovery import PSFailoverSupervisor

    kw = _ps_kwargs(trainer, lease_timeout)
    wal_dir = kw.pop("wal_dir")
    standby = None
    if trainer.ps_standby:
        standby = StandbySocketParameterServer(
            params, rule, W,
            wal_dir=None if wal_dir is None else f"{wal_dir}/standby", **kw)
        standby.initialize()
        standby.start()
        for attempt in range(3):
            # a FaultPlan active during setup may drop the handshake
            try:
                ps.attach_standby("127.0.0.1", standby.port)
                break
            except (ConnectionError, OSError):
                if attempt == 2:
                    raise
    restart_factory = None
    if wal_dir is not None:
        def restart_factory():
            new = SocketParameterServer(params, rule, W, wal_dir=wal_dir,
                                        **kw)
            new.initialize()
            new.start()
            return new
    if kill_plan is not None:
        def kill_hook(version, _ps=ps, _plan=kill_plan):
            if _plan.should_kill_ps(version):
                _plan.note_ps_kill()
                _ps._crash()

        ps.post_commit_hook = kill_hook
    sup = PSFailoverSupervisor(resolver, ps, standby=standby,
                               restart_factory=restart_factory,
                               failover_timeout=float(failover_timeout))
    sup.start()
    return standby, sup


def _raise_worker_errors(trainer, workers, supervisor, budget) -> None:
    """Surface the workers' deaths: fatal unless
    ``tolerate_worker_failures`` and some worker survived (then a
    warning); past a restart budget, as ``RestartBudgetExceeded``."""
    from distkeras_tpu_torch.resilience.recovery import (
        RestartBudgetExceeded,
    )

    errors = [w.error for w in workers if w.error is not None]
    if not errors:
        return
    survivors = len(workers) - len(errors)
    if not trainer.tolerate_worker_failures or survivors == 0:
        first = errors[0]
        if supervisor is not None and not isinstance(first,
                                                     KeyboardInterrupt):
            raise RestartBudgetExceeded(
                f"worker died past its restart budget ({budget} restarts): "
                f"{type(first).__name__}: {first}") from first
        raise first
    warnings.warn(
        f"{len(errors)} of {len(workers)} PS workers failed "
        f"({type(errors[0]).__name__}: {errors[0]}); center trained by "
        f"the {survivors} survivors", stacklevel=3)


__all__ = ["AsyncWorker", "run_async_training", "aggregate_exchange_phases"]
