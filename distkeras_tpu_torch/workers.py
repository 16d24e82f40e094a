"""Asynchronous workers: hogwild replicas driving the card from host threads.

Port of ``distkeras_tpu/workers.py`` (``AsyncWorker``,
``run_async_training``, ``aggregate_exchange_phases``, ``_BoundPS``) for a
fixed or an elastic pool of workers over the in-process, socket,
shared-memory (``shm``) or native transport. Each worker
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
workers under a ``WorkerSupervisor``, which restarts a dead one in a new
thread (a fresh per-thread module: nothing it held on the card is reused)
from its snapshot at the last epoch barrier, else the newest checkpoint's,
else a fresh center pull; ``ps_wal_dir``
makes the server durable; and on the socket transport ``ps_standby`` or a
PS-kill fault starts a ``PSFailoverSupervisor`` that promotes the hot
standby, or restarts the server in place from its WAL, and repoints every
client. ``trainer.resilience_stats_`` reports the exactly-once oracle
(``logical_commits``, to hold against the server's folds), retries,
reconnects, restarts, the injected faults and the failover log.

With ``elastic=True`` the pool is dynamic (``resilience/elastic.py``):
workers lease window blocks from a shared ``ShardAssigner`` instead of
training static shards and confirm each block after its exchange's ACK;
the fault plan's join/preempt events or the autoscaler add workers live
(a joiner sends ``join``, then pulls, so DynSGD prices its first commit
from that pull) and drain them at a window boundary (the in-flight window
committed, its blocks handed back, ``drain`` sent); at depth 1 the
pipelined elastic loop flushes its own deferred exchange rather than wait
on a block it holds itself. Elastic runs take no epoch barrier and no
restart supervisor.

Checkpoints (``checkpoint_dir``) are taken at an epoch barrier: every
worker snapshots its optimizer state and non-trainables (an elastic rule's
worker its params too) and waits; the last to arrive writes the center,
the snapshots, the epoch and the fold count (``checkpoint.py``) and marks
the epoch in the server's log. ``resume`` restores them; with
``ema_decay`` every server folds the Polyak average of the center per
commit, read back into ``trainer.ema_params_``.
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

from distkeras_tpu_torch import checkpoint as ckpt
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
    """Host tree (numpy, or CPU tensors) → tensors on ``device``, always a
    copy."""
    return tree_map(lambda a: a.to(device, copy=True)
                    if isinstance(a, torch.Tensor)
                    else torch.tensor(np.asarray(a), device=device), tree)


class AsyncWorker:
    """One training replica on the card, exchanging with the PS."""

    def __init__(self, worker_id: int, device, window_fn, ps, rule,
                 window: int, batch_size: int, nt, history: list,
                 lock: threading.Lock, codec=None, fused: bool = True,
                 pipeline_depth: int = 0, fault_plan=None, barrier=None,
                 ckpt_pred=None, restore: dict | None = None,
                 start_epoch: int = 0, tolerant: bool = False,
                 assigner=None, drain_event: threading.Event | None = None,
                 coordinator=None, joiner: bool = False):
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
        # the epoch barrier of checkpointing (ckpt_pred(epoch) says which
        # epochs end at it): each worker leaves its snapshot there, and a
        # tolerant worker whose peer died breaking it trains on without
        # one. A restart (or a resume) restores from `restore`
        self.barrier = barrier
        self.ckpt_pred = ckpt_pred
        self.tolerant = bool(tolerant)
        self.snapshot: dict | None = None
        self.restore = restore
        self.start_epoch = int(start_epoch)
        self._epoch_done: int | None = None
        # elastic membership (resilience/elastic.py): with an assigner the
        # worker leases window blocks from the shared per-epoch pool
        # instead of training a static shard; drain_event is its
        # preemption notice (read at window boundaries), the coordinator
        # fires the fault plan's join/preempt events at each window, and
        # a joiner sends the join action before its first pull
        self.assigner = assigner
        self.drain_event = drain_event
        self.coordinator = coordinator
        self.joiner = bool(joiner)
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
            if self.assigner is not None:
                # elastic: shard_cols holds the whole columns, and the
                # assigner (built with the epochs, the seed and the
                # shuffle) hands out the blocks
                pipelined = self.pipeline_depth >= 1 and not isinstance(
                    self.rule, ElasticAverageMerge)
                if pipelined:
                    self._train_elastic_pipelined(shard_cols)
                else:
                    self._train_elastic(shard_cols)
            else:
                self._train(index, shard_cols, num_epoch, shuffle, seed)
        except BaseException as e:
            self.error = e
            if self.barrier is not None:
                self.barrier.abort()  # peers at the barrier must not hang
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
        be deferred: it always exchanges serially. A restored worker takes
        its optimizer state and non-trainables from ``restore``; an elastic
        rule's worker owns its variables, so its params too, while a delta
        rule's re-bases onto the live center, as after any exchange."""
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
        restore = self.restore
        if restore is not None and elastic:
            center = None   # the elastic exchange pulls its own
            params = _to_device(restore["params"], self.device)
        else:
            center = self.ps.pull(self.worker_id)
            params = _to_device(center, self.device)
        base = center          # the window's start, on the host
        nt = _to_device(self.nt, self.device)
        opt = self.window_fn.init_opt(params)
        if restore is not None:
            nt = utils.tree_like(restore["nt"], nt)
            opt = utils.tree_like(restore["opt"], opt)
        pending = None         # window N's (blob, loss, epoch, corr)
        for epoch in range(self.start_epoch, num_epoch):
            order = (np.random.default_rng((seed, index, epoch))
                     .permutation(rows) if shuffle else np.arange(rows))
            for w in range(n_windows):
                self._window_hooks()
                batches = self._batches(
                    shard_cols, order[w * win_rows:(w + 1) * win_rows])
                t_launch = time.perf_counter()
                params, nt, opt, loss = self.window_fn(params, nt, opt,
                                                       batches)
                if pending is not None:
                    center = self._flush(pending, lag=True)
                    pending = None
                if _trace.enabled():
                    self._next_corr()
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
            if self.barrier is not None and self.ckpt_pred(epoch):
                self._epoch_barrier(epoch, params, nt, opt, elastic)
        if pending is not None:
            self._flush(pending, lag=True)   # the last window's exchange
        self.final_nt = utils.tree_to_numpy(nt)

    def _elastic_start(self):
        """The elastic loops' preamble: a joiner's ``join`` (lease
        admitted, the pool counted), the lease's first heartbeat, then the
        pull that records this worker's pull version (so a joiner's first
        DynSGD commit is priced at the true small τ). Returns ``(center,
        params, nt, opt, maybe_heartbeat)``."""
        if self.joiner:
            join = getattr(self.ps, "join", None)
            if join is not None:
                join()
        maybe_heartbeat = getattr(self.ps, "maybe_heartbeat", None)
        if maybe_heartbeat is not None:
            maybe_heartbeat()
        center = self.ps.pull(self.worker_id)
        params = _to_device(center, self.device)
        nt = _to_device(self.nt, self.device)
        return center, params, nt, self.window_fn.init_opt(params), \
            maybe_heartbeat

    def _block_done(self, epoch: int, block: int, maybe_heartbeat) -> None:
        """A block's exchange was acknowledged (durable when a WAL is on):
        confirm it to the assigner, then the window-boundary hooks (the
        lease, the fault plan's seeded join/preempt events)."""
        self.assigner.complete(self.worker_id, epoch, block)
        self._windows_done += 1
        if maybe_heartbeat is not None:
            maybe_heartbeat()
        if self.coordinator is not None:
            self.coordinator.on_window(self.worker_id, self._windows_done)

    def _next_corr(self) -> None:
        """Stamp this thread's correlation id for the window being staged
        (``w<id>:x<n>``); call only while tracing."""
        self._xid += 1
        _trace.set_corr(f"w{self.worker_id}:x{self._xid}")

    def _window_hooks(self) -> None:
        """The fault plan's chaos at a window's start: a kill at this
        worker's window (once; a restart passes the same index unharmed),
        a straggler's sleep every window."""
        if self.fault_plan is not None:
            self.fault_plan.maybe_kill(self.worker_id, self._windows_done)
            self.fault_plan.maybe_straggle(self.worker_id)

    def _train_elastic(self, cols: tuple) -> None:
        """The elastic loop: lease a block, train its window, exchange,
        and confirm the block after the exchange's ACK, until the pool is
        out of work or a preemption notice drains this worker. A drained
        worker leaves at a window boundary (its last window committed and
        confirmed); an elastic rule's worker first commits its final
        elastic difference, so the center keeps what its variable holds
        beyond the center. Any unconfirmed block goes back on exit."""
        elastic_rule = isinstance(self.rule, ElasticAverageMerge)
        center, params, nt, opt, maybe_heartbeat = self._elastic_start()
        drain = self.drain_event
        stop = drain.is_set if drain is not None else None
        try:
            while True:
                if drain is not None and drain.is_set():
                    if elastic_rule and self._windows_done > 0:
                        self._commit_final_elastic(params)
                    break
                task = self.assigner.claim(self.worker_id, stop=stop)
                if task is None:
                    break
                epoch, block, idx = task
                self._window_hooks()
                batches = self._batches(cols, idx)
                t_launch = time.perf_counter()
                params, nt, opt, loss = self.window_fn(params, nt, opt,
                                                       batches)
                if _trace.enabled():
                    self._next_corr()
                loss = float(loss)   # waits for this window on the card
                t0 = self._phase("compute", t_launch)
                if elastic_rule:
                    params, center = self._elastic_exchange(params, t0)
                else:
                    delta = self._window_delta(params, center)
                    t0 = self._phase("fetch", t0)
                    blob, _ = self._compress(delta, owned=True)
                    self._phase("compress", t0)
                    center = self._do_exchange(blob)
                    params = _to_device(center, self.device)
                self._window_done(loss, epoch)
                self._block_done(epoch, block, maybe_heartbeat)
        finally:
            # a leased block never confirmed goes back to the pool: the
            # drain path on a clean exit, the safety net on a death
            self.assigner.release(self.worker_id)
        self.final_nt = utils.tree_to_numpy(nt)

    def _commit_final_elastic(self, params) -> None:
        """A cleanly drained elastic-rule worker's last exchange: a fresh
        center, the final elastic difference ``alpha · (worker − center)``
        committed. The pulled center and the worker's variable stay in
        ``drained_center_`` and ``final_params_``."""
        center = self.ps.pull(self.worker_id)
        host_params = utils.tree_to_numpy(params)
        diff = self.rule.worker_commit(host_params, center)
        blob, _ = self._compress(diff)
        self.ps.commit(self.worker_id, blob)
        self.drained_center_ = center
        self.final_params_ = host_params

    def _train_elastic_pipelined(self, cols: tuple) -> None:
        """The elastic loop at ``ps_pipeline_depth=1`` (delta rules): the
        pipelined data flow of :meth:`_train` over leased blocks. A block
        is confirmed only after its deferred exchange's ACK. When every
        remaining block is in flight, the claim does not wait (it returns
        ``WOULD_BLOCK``): the pool may be waiting on this worker's own
        deferred block, so the worker flushes its exchange first and then
        claims, waiting. A drain, or an empty pool, flushes the pending
        window before the worker leaves."""
        from distkeras_tpu_torch.resilience.elastic import WOULD_BLOCK

        center, params, nt, opt, maybe_heartbeat = self._elastic_start()
        base = center
        drain = self.drain_event
        stop = drain.is_set if drain is not None else None
        pending = None   # window N's (blob, loss, epoch, corr, block)
        try:
            while True:
                if drain is not None and drain.is_set():
                    break   # the flush below commits the in-flight window
                task = self.assigner.claim(self.worker_id, stop=stop,
                                           wait=False)
                if task is WOULD_BLOCK:
                    if pending is not None:
                        center = self._flush_elastic(pending,
                                                     maybe_heartbeat)
                        pending = None
                    task = self.assigner.claim(self.worker_id, stop=stop)
                if task is None:
                    break
                epoch, block, idx = task
                self._window_hooks()
                batches = self._batches(cols, idx)
                t_launch = time.perf_counter()
                params, nt, opt, loss = self.window_fn(params, nt, opt,
                                                       batches)
                if pending is not None:
                    center = self._flush_elastic(pending, maybe_heartbeat)
                    pending = None
                if _trace.enabled():
                    self._next_corr()
                loss = float(loss)
                t0 = self._phase("compute", t_launch)
                delta = self._window_delta(params, base)
                t0 = self._phase("fetch", t0)
                blob, sent = self._compress(delta, owned=True)
                self._phase("compress", t0)
                base = self._rebase_host(center, sent)
                params = _to_device(base, self.device)
                pending = (blob, loss, epoch,
                           _trace.current_corr() if _trace.enabled()
                           else None, block)
            if pending is not None:
                self._flush_elastic(pending, maybe_heartbeat)
                pending = None
        finally:
            self.assigner.release(self.worker_id)
        self.final_nt = utils.tree_to_numpy(nt)

    def _flush_elastic(self, pending, maybe_heartbeat):
        """Exchange one deferred elastic window (priced with ``lag``), then
        confirm its block and run the window-boundary hooks, in the serial
        loop's order. Returns the fresh center."""
        *window, block = pending
        center = self._flush(tuple(window), lag=True)
        self._block_done(window[2], block, maybe_heartbeat)
        return center

    def _epoch_barrier(self, epoch: int, params, nt, opt,
                       elastic: bool) -> None:
        """Leave this worker's snapshot and wait at the checkpoint barrier
        (its action, run by the last to arrive, writes the checkpoint).
        Only an elastic rule's worker saves its params: a delta worker
        re-bases onto the restored center."""
        snap = {"opt": ckpt.host_copy(opt), "nt": ckpt.host_copy(nt)}
        if elastic:
            snap["params"] = ckpt.host_copy(params)
        self.snapshot = snap
        self._epoch_done = epoch
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            if not self.tolerant:
                raise
            # a tolerated peer death broke the rendezvous: train on
            # without further checkpoints
            self.barrier = None

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

    def join(self) -> dict:
        rec = self._ps.join_worker(self.worker_id)
        rec["ok"] = True
        return rec

    def drain(self, timeout: bool = False) -> None:
        self._ps.drain_worker(self.worker_id, timeout=timeout)

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
    """The EMA and resilience arguments every server takes."""
    return dict(ema_decay=trainer.ema_decay,
                lease_timeout=lease_timeout, wal_dir=trainer.ps_wal_dir,
                snapshot_every=trainer.ps_snapshot_every,
                wal_group_window=trainer.ps_wal_group_window,
                wal_group_interval=trainer.ps_wal_group_interval)


def _resilience_stats(clients, supervisor, fault_plan, failover,
                      coordinator=None, directory=None):
    """``trainer.resilience_stats_``: the commit-seqno oracle (logical
    commits the clients saw acknowledged, to hold against the server's
    folds), retry and reconnect totals, supervisor restarts and their log
    (each restart's worker, attempt, error and the state it restored
    ``from``: ``snapshot``, ``checkpoint`` or ``center-pull``), what the
    fault plan injected, the failover log (``failover``: the
    supervisor's, or a sharded group's roll-up of its shards', or None)
    the elastic coordinator's ``stats()`` (or None) and the hosted
    membership directory's ``stats()`` (``directory``, or None)."""
    sup = supervisor.stats() if supervisor else {"restarts": 0,
                                                 "restart_log": []}
    return {
        "logical_commits": sum(int(getattr(c, "seq", 0)) for c in clients),
        "retries": sum(int(getattr(c, "retries", 0)) for c in clients),
        "reconnects": sum(int(getattr(c, "reconnects", 0)) for c in clients),
        "restarts": sup["restarts"],
        "restart_log": sup["restart_log"],
        "faults": fault_plan.stats() if fault_plan is not None else None,
        "ps_failover": failover,
        "elastic": None if coordinator is None else coordinator.stats(),
        "directory": directory,
    }


def run_async_training(trainer, ds, shuffle: bool):
    """Drive the PS backend for a ``DistributedTrainer`` (the reference's
    ``mapPartitionsWithIndex(worker.train).collect()`` job): start the PS
    (or reach the external one at ``ps_host``), run ``num_workers`` worker
    threads over their row shards, and return ``(center, nt, history)``
    with the center as host numpy. Sets ``trainer.ps_stats_`` (the active
    server's ``stats()`` plus ``exchange_phases``; None for an external
    PS; after a failover its op counters start at the takeover, while
    ``num_updates`` spans the run; a sharded center's roll-up carries
    ``num_shards`` and ``per_shard``), ``trainer.resilience_stats_`` (with
    any resilience knob or fault plan; else None),
    ``trainer.exchange_phases_`` (this process's workers' phases, on every
    transport), ``trainer.ema_params_`` (with ``ema_decay``),
    ``trainer.checkpoint_ms_`` (each barrier's checkpoint action) and
    ``trainer.trace_path_``. With ``elastic=True`` an
    :class:`~distkeras_tpu_torch.resilience.elastic.ElasticCoordinator`
    owns the pool (see :func:`_run_elastic`), and
    ``resilience_stats_["elastic"]`` holds its joins, drains, the
    autoscaler's decisions and the assigner's exactly-once ledger. With
    ``directory=True`` a :class:`~distkeras_tpu_torch.directory.
    HostedDirectory` (its WAL under ``<ps_wal_dir>/directory``) registers
    every PS endpoint, and every client, joiners included, is minted from a
    directory lookup; with ``ps_directory`` the clients are minted from an
    external fleet's directory. ``trainer.directory_stats_`` (also
    ``resilience_stats_["directory"]``) holds the hosted directory's
    registrations, counters, failover log and final membership."""
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
    # elastic membership: window blocks leased from a shared assigner, live
    # joins, preemption drains and the autoscaler replace the static
    # shards, the epoch barrier and the restart supervisor
    elastic_mode = trainer.elastic
    ckpt_dir = trainer.checkpoint_dir
    start_epoch, restores, restored_updates = 0, [None] * W, 0
    if ckpt_dir and elastic_mode and not trainer.resume:
        warnings.warn(
            "elastic runs do not write epoch-barrier checkpoints (the "
            "barrier assumes a fixed pool); checkpoint_dir is resume-only "
            "under elastic=True", stacklevel=3)
    if ckpt_dir and trainer.resume:
        params, start_epoch, restores, restored_updates = _resume(
            trainer, params)
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
    if fault_plan is not None and not elastic_mode \
            and getattr(fault_plan, "has_elastic_events", False):
        raise ValueError(
            "fault_plan carries join/preempt membership events but the "
            "trainer is not elastic — set elastic=True (a fixed-pool run "
            "never consults them, so the chaos would silently test "
            "nothing)")
    failover_timeout = trainer.ps_failover_timeout
    if failover_timeout is None:
        failover_timeout = lease_timeout if lease_timeout is not None \
            else 2.0
    kill_ps_chaos = (fault_plan is not None and getattr(
        fault_plan, "kill_ps_after_commits", None) is not None)
    # the sharded center (sharding/): the tree split over ps_num_shards
    # servers, each with ps_chain_length - 1 replicas behind it; one shard
    # with a chain of two is the ps_standby topology, generalised
    num_shards = int(trainer.ps_num_shards)
    chain_length = int(trainer.ps_chain_length)
    sharded = (num_shards > 1 or chain_length > 1) and external_host is None
    shard_supervised = sharded and transport == "socket" and (
        chain_length > 1 or kill_ps_chaos or trainer.ps_wal_dir is not None)
    failover = (not sharded and transport == "socket"
                and external_host is None
                and (trainer.ps_standby or kill_ps_chaos))
    # the membership directory (directory/): hosted beside the fleet it
    # describes (directory=True), or an external fleet's (ps_directory=
    # seeds); either way every client is minted from a lookup, and a
    # reconnect re-resolves through it
    directory_on = trainer.directory
    dir_seeds = trainer.ps_directory
    if (failover or shard_supervised or directory_on
            or dir_seeds is not None) and retry_policy is None:
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
    trainer.directory_stats_ = None
    trainer.ema_params_ = None
    trainer.checkpoint_ms_ = []

    ps = None
    resolver = None
    standby = None
    ps_supervisor = None
    group = None
    hosted = external_directory = None
    if directory_on:
        from distkeras_tpu_torch.directory import HostedDirectory

        # the default lease outlives two failover timeouts (a loaded host
        # renews late); its WAL lives beside the shards'
        hosted = HostedDirectory(
            wal_dir=(None if trainer.ps_wal_dir is None
                     else os.path.join(trainer.ps_wal_dir, "directory")),
            standby=trainer.directory_standby,
            default_ttl=max(2.0 * float(failover_timeout), 1.0),
            failover_timeout=float(failover_timeout), fault_plan=fault_plan)
    if sharded:
        from distkeras_tpu_torch.sharding import ShardedPSGroup

        kw = _ps_kwargs(trainer, lease_timeout)
        group = ShardedPSGroup(
            params, rule, W, num_shards=num_shards, transport=transport,
            wal_root=kw.pop("wal_dir"), chain_length=chain_length, **kw)
        ps = group
    elif dir_seeds is not None:
        # an external fleet found through its directory: the seeds are the
        # only addresses given, and build_client mints each worker's
        # client from a lookup
        from distkeras_tpu_torch.directory import DirectoryClient, parse_seeds

        external_directory = DirectoryClient(parse_seeds(dir_seeds))
    elif external_host is not None and transport == "native":
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
    coordinator = None
    snap_client = None
    try:
        if hosted is not None:
            hosted.start()
        if group is not None:
            # inside the try: a shard that fails to start stops the rest
            group.initialize()
            group.start()
        ps_publish = None
        if hosted is not None and group is None:
            # the single PS is shard 0 of 1; without a supervisor to renew
            # it the entry never expires
            ps_publish = hosted.register_shard(0, ps, None,
                                               supervised=failover)
        if failover:
            standby, ps_supervisor = _start_failover(
                trainer, ps, params, rule, W, lease_timeout, resolver,
                fault_plan if kill_ps_chaos else None, failover_timeout,
                publish=ps_publish)
        if shard_supervised:
            group.start_supervision(
                fault_plan=fault_plan if kill_ps_chaos else None,
                failover_timeout=float(failover_timeout), directory=hosted)
        elif hosted is not None and group is not None:
            # no supervisors to renew their leases: entries that never
            # expire (discovery works; nothing ages out)
            for sid, srv in enumerate(group.servers):
                hosted.register_shard(sid, srv, group.plan,
                                      supervised=False)

        def build_client(i):
            # any id: the elastic coordinator mints joiners' clients here.
            # With a directory, every client comes from a lookup
            if hosted is not None:
                return hosted.build_worker_client(
                    params, offset + i, retry_policy=retry_policy,
                    heartbeat_interval=hb_interval,
                    pull_compression=pull_comp)
            if external_directory is not None:
                from distkeras_tpu_torch.directory import build_ps_client

                return build_ps_client(
                    external_directory, params, offset + i,
                    retry_policy=retry_policy,
                    heartbeat_interval=hb_interval,
                    pull_compression=pull_comp)
            if group is not None:
                # the fan-out client comes whole: its resilient wrapping
                # is per shard, one seqno stream a shard
                return group.make_client(
                    offset + i, pull_compression=pull_comp,
                    retry_policy=retry_policy,
                    heartbeat_interval=hb_interval, resilient=resilient)
            if not resilient:
                return make_client(i)
            return ResilientPSClient(lambda: make_client(i), offset + i,
                                     policy=retry_policy,
                                     heartbeat_interval=hb_interval,
                                     resolver=resolver)

        clients = [] if elastic_mode else [build_client(i) for i in range(W)]
        if restored_updates and ps is not None \
                and not getattr(ps, "recovered_", False):
            # a recovered WAL is the finer-grained truth: only a resume
            # without one seeds the update count
            ps.num_updates = restored_updates
        cols = trainer.features_col + [trainer.label_col]
        shards = None if elastic_mode else ds.worker_shards(
            W, trainer.batch_size, trainer.communication_window, cols,
            seed=trainer.seed if shuffle else None, cover_all=shuffle)
        window_fn = _build_local_window(trainer._loss_step(),
                                        trainer.allocate_optimizer())
        history: list[dict] = []
        hlock = threading.Lock()
        barrier = ckpt_pred = None
        if ckpt_dir and not elastic_mode:
            if ps is None:
                # the external PS's center is pulled on a client of its
                # own under a sentinel worker id: a training worker's
                # pull would record its version and understate its
                # DynSGD staleness after every checkpoint
                snap_client = _snapshot_client(trainer, params,
                                               external_host, transport,
                                               external_directory,
                                               retry_policy)

            def ckpt_pred(epoch):
                return ckpt.should_checkpoint(
                    epoch, trainer.checkpoint_every, trainer.num_epoch)

            def checkpoint_action():
                # in the last worker to arrive, while the rest wait; under
                # a failover the current primary holds the center
                t0 = time.perf_counter()
                live = (ps_supervisor.active if ps_supervisor is not None
                        else ps)
                epoch = workers[0]._epoch_done
                payload = {"center": (live.get_model() if live is not None
                                      else snap_client.pull()),
                           "workers": [w.snapshot for w in workers],
                           "epoch": epoch}
                if live is not None:
                    payload["num_updates"] = live.num_updates
                ckpt.save_checkpoint(ckpt_dir, payload, step=epoch)
                # the one coherent epoch boundary: mark it in the log
                mark = getattr(live if live is not None else snap_client,
                               "mark_epoch", None)
                if mark is not None:
                    try:
                        mark(int(epoch))
                    except Exception:  # noqa: BLE001
                        pass  # advisory: never fail the barrier
                trainer.checkpoint_ms_.append(
                    1e3 * (time.perf_counter() - t0))

            barrier = threading.Barrier(W, action=checkpoint_action)
        if elastic_mode:
            coordinator = _run_elastic(
                trainer, ds, cols, shuffle, start_epoch, build_client,
                window_fn, rule, nt, history, hlock, codec, fault_plan,
                lambda: (ps_supervisor.active if ps_supervisor is not None
                         else ps))
            workers = coordinator.all_workers()
            clients = coordinator.all_clients()
        else:
            workers = [AsyncWorker(
                i, trainer.device, window_fn, clients[i], rule,
                trainer.communication_window, trainer.batch_size, nt,
                history, hlock, codec=codec, fused=trainer.ps_fused_exchange,
                pipeline_depth=trainer.ps_pipeline_depth,
                fault_plan=fault_plan, barrier=barrier, ckpt_pred=ckpt_pred,
                restore=restores[i], start_epoch=start_epoch,
                tolerant=trainer.tolerate_worker_failures)
                for i in range(W)]

        def args_of(i):
            return (i, tuple(col[i] for col in shards), trainer.num_epoch,
                    shuffle, trainer.seed)

        budget = int(trainer.worker_restart_budget)
        if elastic_mode:
            pass   # the coordinator drove the run to its end
        elif budget > 0:
            # restart-with-budget: a dead worker relaunches in a new thread
            # up to `budget` times, from its barrier snapshot, else the
            # newest checkpoint's, else a fresh center pull
            supervisor = WorkerSupervisor(
                workers, args_of, max_restarts=budget,
                restart_delay=trainer.worker_restart_delay,
                fallback_restore=lambda i: _checkpointed_worker(ckpt_dir, i))
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
        sup_err = failover_stats = None
        if ps_supervisor is not None:
            ps_supervisor.stop()
            active = ps_supervisor.active
            sup_err = ps_supervisor.error
            failover_stats = ps_supervisor.stats()
        elif shard_supervised:
            # the group reads each shard's ACTIVE server itself; only the
            # supervisors retire before the final reads
            group.stop_supervision()
            sup_err = group.supervisor_error
            failover_stats = group.failover_stats()
        def surfaced(w):
            # a timeout-drained worker was given up on: whatever its
            # abandoned thread raised later is recorded, not raised
            return (coordinator.worker_error(w) if coordinator is not None
                    else w.error)

        if sup_err is not None and not any(surfaced(w) is not None
                                           for w in workers):
            raise RuntimeError("a PS failover supervisor died while the "
                               "workers survived") from sup_err
        if hosted is not None:
            trainer.directory_stats_ = hosted.stats()
        if (resilient or supervisor is not None
                or fault_plan is not None or coordinator is not None):
            trainer.resilience_stats_ = _resilience_stats(
                clients, supervisor, fault_plan, failover_stats, coordinator,
                trainer.directory_stats_)
        _raise_worker_errors(trainer, workers, supervisor, budget, surfaced)
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
            if trainer.ema_decay is not None:
                trainer.ema_params_ = active.get_ema()
            trainer.ps_stats_ = active.stats()
            trainer.ps_stats_["exchange_phases"] = trainer.exchange_phases_
        if trace_dir is not None:
            trainer.trace_path_ = _trace.save(os.path.join(
                trace_dir, f"ps-trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        if ps_supervisor is not None:
            ps_supervisor.stop()
        for c in clients + [snap_client]:
            if c is not None:
                c.close()
        for server in {id(x): x for x in (
                ps, standby,
                ps_supervisor.active if ps_supervisor else None)
                if x is not None}.values():
            server.stop()
        # the directory goes after the servers it describes
        if hosted is not None:
            hosted.stop()
        if external_directory is not None:
            external_directory.close()
        if trace_owner:
            _trace.disable()
    final_nt = next((w.final_nt for w in workers if hasattr(w, "final_nt")),
                    nt)
    return center, final_nt, history


def _run_elastic(trainer, ds, cols, shuffle, start_epoch, build_client,
                 window_fn, rule, nt, history, hlock, codec, fault_plan,
                 live_server):
    """Drive an ``elastic=True`` run to its end and return its
    :class:`~distkeras_tpu_torch.resilience.elastic.ElasticCoordinator`.

    The coordinator owns the pool: the initial workers, live joiners (the
    fault plan's events or the autoscaler, up to ``max_pool_size``,
    default twice the workers) and preemption drains against
    ``preempt_drain_timeout``. The shared ``ShardAssigner`` owns the data:
    window blocks of a ``(seed, epoch)`` permutation, leased, confirmed
    after their commit's ACK and handed back on a drain, so every example
    trains once an epoch across any clean membership schedule. When the
    last block of an epoch is confirmed, the live server (``live_server()``)
    marks the epoch in its log. Every worker, joiners included, runs on
    the trainer's device."""
    from distkeras_tpu_torch.resilience.elastic import (
        ElasticCoordinator,
        ElasticPolicy,
        ShardAssigner,
    )

    W = trainer.num_workers
    cols_full = tuple(np.asarray(ds[c]) for c in cols)

    def mark_epoch(epoch: int) -> None:
        mark = getattr(live_server(), "mark_epoch", None)
        if mark is not None:
            try:
                mark(int(epoch))
            except Exception:  # noqa: BLE001
                pass   # advisory: a mark never stalls training

    assigner = ShardAssigner(
        len(ds), trainer.communication_window, trainer.batch_size,
        trainer.num_epoch, seed=trainer.seed, shuffle=shuffle,
        start_epoch=start_epoch, on_epoch_complete=mark_epoch)
    max_pool = trainer.max_pool_size
    if max_pool is None:
        max_pool = 2 * W   # joins need headroom; unbounded is a footgun
    target = trainer.autoscale_target
    if isinstance(target, ElasticPolicy):
        policy = target
    elif target is not None:
        policy = ElasticPolicy(target_rounds_per_sec=float(target),
                               max_workers=int(max_pool))
    else:
        policy = None
    coordinator = None

    def spawn(worker_id, joiner):
        client = build_client(worker_id)
        w = AsyncWorker(
            worker_id, trainer.device, window_fn, client, rule,
            trainer.communication_window, trainer.batch_size, nt, history,
            hlock, codec=codec, fused=trainer.ps_fused_exchange,
            pipeline_depth=trainer.ps_pipeline_depth, fault_plan=fault_plan,
            tolerant=trainer.tolerate_worker_failures, assigner=assigner,
            drain_event=threading.Event(), coordinator=coordinator,
            joiner=joiner)
        t = threading.Thread(
            target=w.train, daemon=True, name=f"distkeras-elastic-{worker_id}",
            args=(worker_id, cols_full, trainer.num_epoch, shuffle,
                  trainer.seed))
        t.start()
        return w, client, t

    coordinator = ElasticCoordinator(
        assigner, spawn, make_drain_client=build_client,
        fault_plan=fault_plan, policy=policy,
        drain_timeout=trainer.preempt_drain_timeout,
        max_pool_size=int(max_pool))
    try:
        coordinator.start(list(range(W)))
        coordinator.run()
    except BaseException:
        # a worker or client that failed to start: stop the rest at their
        # next window boundary and tear their connections down
        for w in coordinator.all_workers():
            w.drain_event.set()
        for c in coordinator.all_clients():
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        raise
    return coordinator


def _resume(trainer, params):
    """``(center, start epoch, per-worker restores, fold count)`` from the
    newest checkpoint in ``trainer.checkpoint_dir`` (the fresh ``params``
    and nothing restored when there is none). The same worker count
    restores every worker's snapshot; another count, a checkpoint the JAX
    package wrote (its optax state has no counterpart here), or an elastic
    trainer (its pool is dynamic) resumes elastically from the center."""
    from distkeras_tpu_torch.convert import center_from_jax

    W = trainer.num_workers
    if ckpt.latest_step(trainer.checkpoint_dir) is None:
        return params, 0, [None] * W, 0
    payload, _, origin = ckpt.load_checkpoint(trainer.checkpoint_dir)
    saved = payload["workers"]
    restores = [None] * W
    if origin == "jax":
        center = utils.tree_to_numpy(center_from_jax(payload["center"],
                                                     trainer.spec))
    else:
        center = payload["center"]
    if origin == "port" and len(saved) == W and not trainer.elastic:
        restores = list(saved)
    else:
        ckpt.warn_elastic_resume(len(saved), W)
    return (center, int(np.asarray(payload["epoch"])) + 1, restores,
            int(np.asarray(payload.get("num_updates", 0))))


def _checkpointed_worker(ckpt_dir, i: int) -> dict | None:
    """Worker ``i``'s snapshot in the newest checkpoint the port wrote, or
    None (the supervisor's fallback when a worker died before its first
    barrier snapshot)."""
    if not ckpt_dir or ckpt.latest_step(ckpt_dir) is None:
        return None
    payload, _, origin = ckpt.load_checkpoint(ckpt_dir)
    saved = (payload.get("workers") or []) if origin == "port" else []
    return saved[i] if i < len(saved) else None


def _snapshot_client(trainer, params, host: str, transport: str,
                     directory=None, retry_policy=None):
    """A client of the external PS under the sentinel worker id
    ``2**32 − 1`` (no commit ever uses it), for the barrier's center
    pull; minted from a lookup when the fleet is found through a
    ``directory`` (a ``DirectoryClient``)."""
    sentinel = 2**32 - 1
    if directory is not None:
        from distkeras_tpu_torch.directory import build_ps_client

        return build_ps_client(directory, params, sentinel,
                               retry_policy=retry_policy)
    if transport == "native":
        from distkeras_tpu_torch.native_ps import FlatSpec, NativePSClient

        return NativePSClient(host, int(trainer.ps_port), sentinel,
                              FlatSpec(params))
    return ParameterServerClient(host, int(trainer.ps_port), sentinel)


def _start_failover(trainer, ps, params, rule, W, lease_timeout, resolver,
                    kill_plan, failover_timeout, publish=None):
    """The socket transport's failover wiring: the hot standby (with
    ``ps_standby``; its WAL under ``<ps_wal_dir>/standby``) attached to the
    primary, a restart-in-place factory (with ``ps_wal_dir``), the PS-kill
    chaos hook in the commit path (deterministic in commit count, tearing
    in-flight ACKs like a real kill), and the started supervisor (which
    writes the membership directory's entry through ``publish``). Returns
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
                               failover_timeout=float(failover_timeout),
                               publish=publish)
    sup.start()
    return standby, sup


def _raise_worker_errors(trainer, workers, supervisor, budget,
                         surfaced) -> None:
    """Surface the workers' deaths (``surfaced(w)``: a worker's error as
    the run counts it): fatal unless ``tolerate_worker_failures`` and some
    worker survived (then a warning); past a restart budget, as
    ``RestartBudgetExceeded``."""
    from distkeras_tpu_torch.resilience.recovery import (
        RestartBudgetExceeded,
    )

    errors = [e for w in workers if (e := surfaced(w)) is not None]
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
