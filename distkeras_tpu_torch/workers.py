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
"""

from __future__ import annotations

import bisect
import os
import threading
import time
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
                 pipeline_depth: int = 0):
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
        kept on ``self.error`` for the trainer."""
        try:
            self._train(index, shard_cols, num_epoch, shuffle, seed)
        except BaseException as e:
            self.error = e

    def _train(self, index, shard_cols, num_epoch, shuffle, seed):
        """The window loop. A delta rule's window ends in a pending
        exchange: at depth 0 it is flushed before the next window
        launches, at depth 1 just after (window N's exchange runs on the
        host while window N+1 runs on the card, and N+1 starts from
        ``C_{N-1} + sent_N``). ``compute`` spans a window's launch to its
        loss on the host, so at depth 1 it contains the previous window's
        exchange. An elastic rule's commit needs a fresh pull, so it cannot
        be deferred: it always exchanges serially."""
        rows = len(shard_cols[0])
        win_rows = self.window * self.batch_size
        n_windows = rows // win_rows
        elastic = isinstance(self.rule, ElasticAverageMerge)
        pipelined = self.pipeline_depth >= 1 and not elastic
        center = self.ps.pull(self.worker_id)
        params = _to_device(center, self.device)
        base = center          # the window's start, on the host
        nt = _to_device(self.nt, self.device)
        opt = self.window_fn.init_opt(params)
        pending = None         # window N's (blob, loss, epoch, corr)
        for epoch in range(num_epoch):
            order = (np.random.default_rng((seed, index, epoch))
                     .permutation(rows) if shuffle else np.arange(rows))
            for w in range(n_windows):
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
                 pull_compression: str | None = None):
        self._ps = ps
        self.worker_id = worker_id
        self.pull_compression = validate_pull_compression(pull_compression)

    def pull(self, worker_id: int | None = None):
        if self.pull_compression == "int8":
            return maybe_decode(self._ps.pull(self.worker_id,
                                              compressed=True))
        return self._ps.pull(self.worker_id)

    def commit(self, worker_id: int | None, payload):
        self._ps.commit(self.worker_id, payload)

    def exchange(self, worker_id: int | None, payload, lag: bool = False):
        blob, _applied = self._ps.exchange(
            self.worker_id, payload, lag=lag,
            compressed=self.pull_compression == "int8")
        return maybe_decode(blob)

    def close(self):
        pass


def _join_workers(threads, workers) -> None:
    """Join every worker thread in bounded slices. A live worker whose last
    window ended longer ago than its stall limit raises ``TimeoutError``
    naming it; its daemon thread is left behind, and the caller's
    ``finally`` closes the clients and stops the PS."""
    pending = list(zip(threads, workers))
    while pending:
        pending[0][0].join(timeout=_JOIN_SLICE_S)
        pending = [(t, w) for t, w in pending if t.is_alive()]
        now = time.monotonic()
        for t, w in pending:
            limit = max(_STALL_FLOOR_S, _STALL_WINDOWS * w.slowest_s)
            if now - w.progress_t > limit:
                raise TimeoutError(
                    f"PS worker {w.worker_id} ({t.name}) finished no window "
                    f"in {limit:.0f} s: stuck in an exchange or on the "
                    f"device")


def run_async_training(trainer, ds, shuffle: bool):
    """Drive the PS backend for a ``DistributedTrainer`` (the reference's
    ``mapPartitionsWithIndex(worker.train).collect()`` job): start the PS
    (or reach the external one at ``ps_host``), run ``num_workers`` worker
    threads over their row shards, and return ``(center, nt, history)``
    with the center as host numpy. Sets ``trainer.ps_stats_`` (the server's
    ``stats()`` plus ``exchange_phases``; None for an external PS),
    ``trainer.exchange_phases_`` (this process's workers' phases, on every
    transport) and ``trainer.trace_path_``."""
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

    trace_dir = trainer.trace_dir
    trace_on = bool(trainer.trace) or trace_dir is not None
    trace_owner = trace_on and not _trace.enabled()
    if trace_owner:
        _trace.enable(sample=float(trainer.trace_sample))
    trainer.trace_path_ = None
    trainer.ps_stats_ = None

    ps = None
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
                                         port=trainer.ps_port)
        ps.initialize()
        ps.start()

        def make_client(i):
            return NativePSClient("127.0.0.1", ps.port, i, ps.spec,
                                  pull_compression=pull_comp)
    elif transport == "shm":
        from distkeras_tpu_torch.shm import ShmParameterServer, ShmPSClient

        ps = ShmParameterServer(params, rule, W)
        ps.initialize()
        ps.start()

        def make_client(i):
            return ShmPSClient(ps, i, pull_compression=pull_comp)
    elif transport == "socket":
        ps = SocketParameterServer(params, rule, W, port=trainer.ps_port)
        ps.initialize()
        ps.start()

        def make_client(i):
            return ParameterServerClient("127.0.0.1", ps.port, i,
                                         pull_compression=pull_comp)
    elif transport == "inprocess":
        ps = ParameterServer(params, rule, W)

        def make_client(i):
            return _BoundPS(ps, i, pull_compression=pull_comp)
    else:
        raise ValueError(f"unknown ps_transport {transport!r}")

    clients: list = []
    try:
        clients = [make_client(i) for i in range(W)]
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
                               pipeline_depth=trainer.ps_pipeline_depth)
                   for i in range(W)]
        threads = [threading.Thread(
            target=w.train, daemon=True, name=f"distkeras-worker-{i}",
            args=(i, tuple(col[i] for col in shards), trainer.num_epoch,
                  shuffle, trainer.seed)) for i, w in enumerate(workers)]
        for t in threads:
            t.start()
        _join_workers(threads, workers)
        errors = [w.error for w in workers if w.error is not None]
        if errors:
            raise errors[0]
        trainer.exchange_phases_ = aggregate_exchange_phases(workers)
        if ps is None:
            # the external PS owns the center: a last snapshot over the wire
            clients[0].set_timeout(60.0)
            center = clients[0].pull()
        else:
            center = ps.get_model()
            trainer.ps_stats_ = ps.stats()
            trainer.ps_stats_["exchange_phases"] = trainer.exchange_phases_
        if trace_dir is not None:
            trainer.trace_path_ = _trace.save(os.path.join(
                trace_dir, f"ps-trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        for c in clients:
            c.close()
        if ps is not None:
            ps.stop()
        if trace_owner:
            _trace.disable()
    final_nt = next((w.final_nt for w in workers if hasattr(w, "final_nt")),
                    nt)
    return center, final_nt, history


__all__ = ["AsyncWorker", "run_async_training", "aggregate_exchange_phases"]
