"""The port's elastic membership (``distkeras_tpu_torch/resilience/
elastic.py``, ``observability/{timeseries,watch}.py``, the ``join`` /
``drain`` actions of every PS transport and the elastic worker loops) held
against the JAX package's on the CPU.

The oracles are the reference's own (``tests/test_elastic.py``,
``tests/test_exchange.py``'s elastic cases, ``tests/test_sharding.py``'s
sharded live join, ``tests/test_watch.py``'s rate definitions): under
seeded mid-run joins and preemptions a PS run completes, learns, trains
every example exactly once an epoch (the ``ShardAssigner`` ledger) and
folds every logical commit exactly once a shard; the pool's membership
shows in ``ps.stats()`` on every transport.

Across packages, with the same seeds and the same scripted inputs: the
assigners hand out identical rows (the ``(seed, epoch)`` permutation is
numpy's in both), the policies make identical decisions, the Python and
native servers count joins and drains identically, and a one-worker
elastic DOWNPOUR run, shuffled, gives losses within rtol 1e-6 and a center
within 1e-5 absolute in f32 of the JAX package's run (the bound
``tests/test_torch_ps.py`` holds the fixed-pool run to). The time series
and the rate definitions are held to tolerance 0.

No test can hang: sockets carry timeouts, training runs run under a
watchdog, and every server and thread a test starts is stopped or joined
before it ends.
"""

import copy
import dataclasses
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu import data as jdata
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.observability import timeseries as jts
from distkeras_tpu.observability import watch as jwatch
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.resilience import elastic as jel
from distkeras_tpu_torch import native, trainers
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch import workers as tworkers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.observability import timeseries as tts
from distkeras_tpu_torch.observability import watch as twatch
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.resilience import (
    WOULD_BLOCK,
    ElasticCoordinator,
    ElasticPolicy,
    FaultPlan,
    RetryPolicy,
    ShardAssigner,
)
from distkeras_tpu_torch.sharding import ShardedPSGroup
from distkeras_tpu_torch.shm import ShmParameterServer, ShmPSClient
from tests.test_torch_ps import TIMEOUT, _spec, blobs
from tests.test_torch_resilience import _watchdog
from tests.test_torch_sharding import _full, _model_tree


def epoch_mean_loss(trainer, epoch):
    """Mean loss over one epoch's windows. Elastic histories interleave
    across epochs (a drained worker's early-epoch window can land last),
    so convergence is judged by per-epoch means."""
    return float(np.mean([r["loss"] for r in trainer.get_history()
                          if "loss" in r and r.get("epoch") == epoch]))


def _kw(**extra):
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=2, batch_size=16,
              communication_window=2, num_epoch=2, backend="ps",
              device="cpu")
    kw.update(extra)
    return kw


def _ds(n):
    return Dataset.from_arrays(*blobs(n=n))


def _train(t, ds, shuffle=True):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _watchdog(lambda: t.train(ds, shuffle=shuffle))


def _workers_seen(t):
    return {r.get("worker") for r in t.get_history() if "loss" in r}


# -- FaultPlan: deterministic join/preempt events ----------------------------


def test_fault_plan_join_preempt_fire_once_each():
    plan = FaultPlan(join_worker_at_window={0: 2},
                     preempt_worker_at_window={1: 4})
    assert plan.has_elastic_events
    assert not plan.take_join(0, 1)
    assert not plan.take_join(1, 2)
    assert plan.take_join(0, 2)
    assert not plan.take_join(0, 2)       # once only: a replay is safe
    assert not plan.take_preempt(1, 2)
    assert plan.take_preempt(1, 4)
    assert not plan.take_preempt(1, 4)
    s = plan.stats()
    assert s["joins"] == 1 and s["preempts"] == 1
    assert not FaultPlan(kill_at={0: 1}).has_elastic_events


def test_fault_plan_event_ordering_is_window_deterministic():
    """Events key on (worker, completed-window count), the ``kill_at``
    seam, so the same window sequence fires the same events in the same
    order in both packages."""
    from distkeras_tpu.resilience import FaultPlan as JFaultPlan

    orders = []
    for cls in (FaultPlan, JFaultPlan):
        plan = cls(join_worker_at_window={0: 1},
                   preempt_worker_at_window={0: 3})
        order = []
        for w in range(1, 5):
            if plan.take_join(0, w):
                order.append(("join", w))
            if plan.take_preempt(0, w):
                order.append(("preempt", w))
        orders.append(order)
    assert orders[0] == orders[1] == [("join", 1), ("preempt", 3)]


# -- ShardAssigner: the exactly-once-per-epoch oracle ------------------------


def test_assigner_fixed_pool_exactly_once_with_full_coverage():
    a = ShardAssigner(n_rows=64, window=2, batch_size=4, num_epoch=2,
                      seed=3, shuffle=True)
    assert a.blocks_per_epoch == 8
    seen: dict[int, list] = {0: [], 1: []}
    while (task := a.claim(0)) is not None:
        e, b, idx = task
        seen[e].append(idx)
        a.complete(0, e, b)
    o = a.oracle()
    assert o["exactly_once"] and o["blocks_done"] == 16
    for e in (0, 1):
        rows = np.concatenate(seen[e])
        assert len(rows) == len(set(rows.tolist())) == 64
        np.testing.assert_array_equal(np.sort(rows), np.arange(64))
    assert not np.array_equal(np.concatenate(seen[0]),
                              np.concatenate(seen[1]))


def test_assigner_exactly_once_across_join_and_drain():
    """Worker 0 trains a block, claims another and is drained before it
    confirms it: the block goes back and the joiner, worker 1, trains it.
    No example dropped or duplicated."""
    a = ShardAssigner(n_rows=48, window=1, batch_size=8, num_epoch=1)
    covered = []
    e0, b0, idx0 = a.claim(0)
    a.complete(0, e0, b0)
    covered.append(idx0)
    _, b_hold, _ = a.claim(0)
    assert a.release(0) == 1
    assert a.oracle()["released_blocks"] == 1
    blocks_seen = set()
    while (task := a.claim(1)) is not None:
        e, b, idx = task
        blocks_seen.add(b)
        covered.append(idx)
        a.complete(1, e, b)
    assert b_hold in blocks_seen
    assert a.oracle()["exactly_once"], a.oracle()
    np.testing.assert_array_equal(np.sort(np.concatenate(covered)),
                                  np.arange(48))


def test_assigner_claim_blocks_until_release_then_drains():
    """A worker whose pool is all in flight waits (the holder may drain and
    hand blocks back) instead of dropping work."""
    a = ShardAssigner(n_rows=8, window=1, batch_size=8, num_epoch=1)
    a.claim(0)
    got = []
    t = threading.Thread(target=lambda: got.append(a.claim(1)), daemon=True)
    t.start()
    time.sleep(0.15)
    assert not got
    a.release(0)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and got and got[0] is not None
    e, b, _ = got[0]
    a.complete(1, e, b)
    assert a.claim(1) is None
    assert a.oracle()["exactly_once"]


def test_assigner_stale_completion_after_forced_release():
    """A timeout-drained worker's late ``complete`` is refused and counted:
    the block belongs to its new owner, and the ledger reports the
    at-least-once window honestly."""
    a = ShardAssigner(n_rows=16, window=1, batch_size=8, num_epoch=1)
    e, b, _ = a.claim(0)
    a.release(0)
    assert a.complete(0, e, b) is False
    e1, b1, _ = a.claim(1)
    assert (e1, b1) == (e, b)
    a.complete(1, e1, b1)
    task = a.claim(1)
    a.complete(1, task[0], task[1])
    o = a.oracle()
    assert o["stale_completions"] == 1 and not o["exactly_once"]


def test_assigner_respects_start_epoch():
    a = ShardAssigner(n_rows=16, window=1, batch_size=8, num_epoch=3,
                      start_epoch=2)
    epochs = set()
    while (task := a.claim(0)) is not None:
        epochs.add(task[0])
        a.complete(0, task[0], task[1])
    assert epochs == {2}


@pytest.mark.parametrize("shuffle", [True, False])
def test_assigner_hands_out_the_jax_packages_rows(shuffle):
    """Both packages' assigners, driven by one seeded schedule of claims,
    completions, releases (drains) and stale completions over three
    workers, hand out identical ``(epoch, block, rows)`` and end with
    identical ledgers (tolerance 0)."""
    kw = dict(n_rows=200, window=2, batch_size=8, num_epoch=3, seed=11,
              shuffle=shuffle, start_epoch=1)
    pair = (ShardAssigner(**kw), jel.ShardAssigner(**kw))
    rng = np.random.default_rng(5)
    held: dict[int, list] = {0: [], 1: [], 2: []}
    steps = 0
    while steps < 400:
        steps += 1
        wid = int(rng.integers(3))
        op = rng.random()
        if op < 0.55 or not held[wid]:
            got = [a.claim(wid, wait=False) for a in pair]
            if got[0] is None:
                assert got[1] is None   # every block of every epoch done
                break
            if got[0] is WOULD_BLOCK:
                assert got[1] is jel.WOULD_BLOCK
                continue
            (e, b, idx), (je, jb, jidx) = got
            assert (e, b) == (je, jb)
            np.testing.assert_array_equal(idx, jidx)
            held[wid].append((e, b))
        elif op < 0.9:
            e, b = held[wid].pop(0)
            assert [a.complete(wid, e, b) for a in pair] == [True, True]
        else:
            assert pair[0].release(wid) == pair[1].release(wid)
            if held[wid] and rng.random() < 0.5:
                e, b = held[wid][0]   # the drained worker's late confirm
                assert [a.complete(wid, e, b) for a in pair] == \
                    [False, False]
            held[wid] = []
    assert pair[0].oracle() == pair[1].oracle()
    assert pair[0].oracle()["claims"] > 20


# -- ElasticPolicy: the autoscaler's decisions --------------------------------


def test_policy_grows_under_target_and_shrinks_over_it():
    p = ElasticPolicy(target_rounds_per_sec=10.0, max_workers=4,
                      cooldown_s=0.0)
    assert p.observe(0.0, {0: 0, 1: 0}) == []
    assert p.observe(1.0, {0: 2, 1: 2}) == [("join", None)]
    assert p.observe(2.0, {0: 14, 1: 10, 2: 0}) == [("release", 2)]
    assert [d["action"] for d in p.decisions] == ["join", "release"]
    assert [d["t"] for d in p.decisions] == [1.0, 2.0]


def test_policy_releases_persistent_straggler_only_after_patience():
    p = ElasticPolicy(patience=2, cooldown_s=0.0)
    p.observe(0.0, {0: 0, 1: 0, 2: 0})
    assert p.observe(1.0, {0: 10, 1: 10, 2: 0}) == []
    assert p.observe(2.0, {0: 20, 1: 20, 2: 0}) == [("release", 2)]
    p2 = ElasticPolicy(patience=2, cooldown_s=0.0)
    p2.observe(0.0, {0: 0, 1: 0})
    p2.observe(1.0, {0: 10, 1: 0})
    p2.observe(2.0, {0: 20, 1: 10})       # caught back up
    assert p2.observe(3.0, {0: 30, 1: 10}) == []


def test_policy_cooldown_and_max_workers():
    p = ElasticPolicy(target_rounds_per_sec=100.0, max_workers=2,
                      cooldown_s=10.0)
    p.observe(0.0, {0: 0})
    assert p.observe(1.0, {0: 1}) == [("join", None)]
    assert p.observe(2.0, {0: 2, 1: 0}) == []         # in cooldown
    assert p.observe(13.0, {0: 3, 1: 1}) == []        # at max_workers
    with pytest.raises(ValueError, match="max_workers"):
        ElasticPolicy(min_workers=3, max_workers=2)


def _strip_t(decisions):
    return [{k: v for k, v in d.items() if k != "t"} for d in decisions]


def test_policy_decisions_match_the_jax_package():
    """The same seeded progressions (stragglers, growth, overshoot, a
    changing pool) through both packages' policies, by counts and by the
    shared series: identical actions and decision records (the port's
    records add the observation time ``t``)."""
    rng = np.random.default_rng(9)
    kw = dict(target_rounds_per_sec=40.0, max_workers=6, cooldown_s=1.5,
              patience=2, window_s=2.5)
    pol = (ElasticPolicy(**kw), jel.ElasticPolicy(**kw))
    ser = (ElasticPolicy(**kw), jel.ElasticPolicy(**kw))
    stores = (tts.TimeSeriesStore(), jts.TimeSeriesStore())
    counts = {0: 0, 1: 0, 2: 0}
    for step in range(60):
        now = 0.5 * step
        for wid in list(counts):
            counts[wid] += int(rng.integers(0, 3 if wid != 2 else 1) * 4)
        if step == 20:
            counts[3] = 0
        if step == 40:
            counts.pop(1)
        for st in stores:
            for wid, n in counts.items():
                st.sample(f"worker.{wid}.windows", now, n, "counter")
        assert pol[0].observe(now, counts) == pol[1].observe(now, counts)
        assert ser[0].observe_series(stores[0], now, wids=counts.keys()) \
            == ser[1].observe_series(stores[1], now, wids=counts.keys())
    for a, b in (pol, ser):
        assert _strip_t(a.decisions) == b.decisions
        assert len(b.decisions) >= 3


# -- the rates, the straggler and the time series -----------------------------


def test_rates_and_straggler_definitions():
    for mod, store in ((twatch, tts.TimeSeriesStore),
                       (jwatch, jts.TimeSeriesStore)):
        rates = mod.rates_from_counts(0.0, {0: 0, 1: 0}, 2.0,
                                      {0: 8, 1: 2, 2: 4})
        assert rates == {0: 4.0, 1: 1.0, 2: 2.0}
        med, lag = mod.straggler_workers({0: 10.0, 1: 0.5, 2: 9.0}, 0.25)
        assert med == 9.0 and lag == [1]
        assert mod.straggler_workers({0: 1.0}, 0.25) == (0.0, [])
        st = store()
        for t, v in [(0.0, 0), (2.0, 8)]:
            st.sample("worker.0.windows", t, v, "counter")
        st.sample("worker.9.windows", 2.0, 1, "counter")
        assert mod.worker_rates(st, 10.0, 2.0) == {0: 4.0}
        assert mod.rounds_per_sec(st, 10.0, 2.0) == 4.0


def test_elastic_policy_observe_and_observe_series_agree():
    """Fed the same progression, the counts path and the shared-series
    path make the same decisions (a join under target, then a straggler
    release)."""
    steps = [(0.0, {0: 0, 1: 0, 2: 0}), (1.0, {0: 2, 1: 2, 2: 2}),
             (2.0, {0: 14, 1: 10, 2: 2})]
    p1 = ElasticPolicy(target_rounds_per_sec=10.0, max_workers=4,
                       cooldown_s=0.0, patience=1)
    got1 = [p1.observe(t, c) for t, c in steps]
    p2 = ElasticPolicy(target_rounds_per_sec=10.0, max_workers=4,
                       cooldown_s=0.0, patience=1, window_s=1.5)
    store = tts.TimeSeriesStore()
    got2 = []
    for t, counts in steps:
        for wid, n in counts.items():
            store.sample(f"worker.{wid}.windows", t, n, "counter")
        got2.append(p2.observe_series(store, t, wids=counts.keys()))
    assert got1 == [[], [("join", None)], [("release", 2)]]
    assert got2 == got1


def test_timeseries_store_matches_the_jax_package(tmp_path):
    """The same samples (past two downsamplings of each kind) give both
    packages' stores the same points, rates, deltas and reset-aware
    increases; a ``.gz`` dump reads back through either package."""
    rng = np.random.default_rng(2)
    ours, theirs = tts.TimeSeriesStore(capacity=8), jts.TimeSeriesStore(
        capacity=8)
    n = 0.0
    for i in range(37):
        n = 0.0 if i == 20 else n + float(rng.integers(0, 5))  # a reset
        g = float(rng.normal())
        for st in (ours, theirs):
            st.sample("c", 0.25 * i, n, "counter")
            st.sample("g", 0.25 * i, g, "gauge")
    assert ours.to_json() == theirs.to_json()
    for w in (1.0, 3.0, 100.0):
        for name in ("c", "g"):
            assert ours.rate(name, w) == theirs.rate(name, w)
            assert ours.delta(name, w) == theirs.delta(name, w)
            assert ours.increase(name, w) == theirs.increase(name, w)
    with pytest.raises(ValueError, match="counter"):
        ours.sample("c", 99.0, 1.0, "gauge")
    path = ours.dump(str(tmp_path / "ts.json.gz"), extra={"alerts": []})
    assert tts.TimeSeriesStore.load(path).to_json() == ours.to_json()
    assert jts.TimeSeriesStore.load(path).to_json() == ours.to_json()
    plain = ours.dump(str(tmp_path / "ts.json"))
    assert tts.TimeSeriesStore.load(plain).to_json() == ours.to_json()


# -- the join/drain protocol and the pool's stats, per transport --------------


def test_join_and_drain_counters_inprocess():
    ps = tps.ParameterServer({"w": np.zeros(2, np.float32)},
                             tr.DownpourMerge(), 2)
    s = ps.stats()
    assert s["pool_size"] == 2 and s["joined_workers"] == 0
    assert ps.join_worker(5)["pool_size"] == 3
    assert ps._registry.active() == [5]   # leased, quietly
    assert ps.stats()["heartbeats"] == 0  # a join is not a heartbeat
    ps.drain_worker(5)
    s = ps.stats()
    assert s["pool_size"] == 2
    assert s["joined_workers"] == 1 and s["preempted_workers"] == 1
    assert s["drain_timeouts"] == 0 and s["evicted_workers"] == 0
    ps.drain_worker(7, timeout=True)      # the force-drain path
    s = ps.stats()
    assert s["drain_timeouts"] == 1 and s["preempted_workers"] == 2


def test_join_and_drain_are_lost_ack_replay_safe():
    """A join or drain replayed after a lost ACK counts once, until the
    worker's membership really flips again; an eviction retires both
    records."""
    ps = tps.ParameterServer({"w": np.zeros(2, np.float32)},
                             tr.DownpourMerge(), 2)
    ps.join_worker(4)
    ps.join_worker(4)
    s = ps.stats()
    assert s["joined_workers"] == 1 and s["pool_size"] == 3
    ps.drain_worker(4)
    ps.drain_worker(4)
    s = ps.stats()
    assert s["preempted_workers"] == 1 and s["pool_size"] == 2
    ps.join_worker(4)                     # a real re-join counts again
    ps.drain_worker(4)
    s = ps.stats()
    assert s["joined_workers"] == 2 and s["preempted_workers"] == 2
    assert s["pool_size"] == 2
    ps.join_worker(6)
    ps._on_evict([6])
    assert 6 not in ps._joined_wids and 6 not in ps._drained_wids


_MEMBERSHIP = ("pool_size", "joined_workers", "preempted_workers",
               "drain_timeouts")


def _membership(stats):
    return tuple(stats[k] for k in _MEMBERSHIP)


def _membership_script(join, drain, stats):
    """One action sequence (replays, a re-join, a force-drain, a drain of
    a worker that never joined); the membership counters after each."""
    out = []
    for op, wid, timeout in (("join", 5, False), ("join", 5, False),
                             ("drain", 5, False), ("drain", 5, False),
                             ("join", 5, False), ("join", 6, False),
                             ("drain", 6, True), ("drain", 9, False),
                             ("drain", 5, False)):
        if op == "join":
            rec = join(wid)
            out.append(("join", rec["pool_size"], rec["num_updates"]))
        else:
            drain(wid, timeout)
        out.append(_membership(stats()))
    return out


@pytest.mark.parametrize("transport", ["inprocess", "socket"])
def test_join_drain_stats_match_the_jax_package(transport):
    """The port's and the JAX package's Python servers count the same
    action sequence identically, in process and over the socket wire
    (each package's client against its own server)."""
    center = {"w": np.zeros(2, np.float32)}
    if transport == "inprocess":
        runs = []
        for mod, rule in ((tps, tr.DownpourMerge()),
                          (jps, jr.DownpourMerge())):
            ps = mod.ParameterServer(center, rule, 2)
            runs.append(_membership_script(
                ps.join_worker,
                lambda w, to, ps=ps: ps.drain_worker(w, timeout=to),
                ps.stats))
        assert runs[0] == runs[1]
        return
    runs = []
    for mod, rule in ((tps, tr.DownpourMerge()), (jps, jr.DownpourMerge())):
        ps = mod.SocketParameterServer(center, rule, 2)
        ps.initialize()
        ps.start()
        clients: dict = {}
        try:
            def client(w, mod=mod, ps=ps):
                if w not in clients:
                    clients[w] = mod.ParameterServerClient(
                        "127.0.0.1", ps.port, w)
                return clients[w]

            runs.append(_membership_script(
                lambda w: client(w).join(),
                lambda w, to: client(w).drain(timeout=to), ps.stats))
        finally:
            for c in clients.values():
                c.close()
            ps.stop()
    assert runs[0] == runs[1]


def test_join_and_drain_over_socket_wire_retires_dedup_seqno():
    ps = tps.SocketParameterServer({"w": np.zeros(2, np.float32)},
                                   tr.DownpourMerge(), 1)
    ps.initialize()
    ps.start()
    try:
        c = tps.ParameterServerClient("127.0.0.1", ps.port, 3)
        c.set_timeout(TIMEOUT)
        rec = c.join()
        assert rec["ok"] and rec["pool_size"] == 2
        c.commit(3, {"w": np.ones(2, np.float32)}, seq=9)
        assert 3 in ps._last_seq
        c.drain(timeout=False)
        assert 3 not in ps._last_seq
        s = ps.stats()
        assert s["pool_size"] == 1
        assert s["joined_workers"] == 1 and s["preempted_workers"] == 1
        c.close()
    finally:
        ps.stop()


def test_join_and_drain_over_shm_rings_retires_dedup_seqno():
    """The shm rings speak the elastic protocol with the socket wire's
    accounting and dedup retirement."""
    ps = ShmParameterServer({"w": np.zeros(2, np.float32)},
                            tr.DownpourMerge(), 1)
    ps.initialize()
    ps.start()
    try:
        c = ShmPSClient(ps, 3)
        rec = c.join()
        assert rec["ok"] and rec["pool_size"] == 2
        c.commit(3, {"w": np.ones(2, np.float32)}, seq=9)
        assert 3 in ps._last_seq
        c.drain(timeout=False)
        assert 3 not in ps._last_seq
        s = ps.stats()
        assert s["pool_size"] == 1
        assert s["joined_workers"] == 1 and s["preempted_workers"] == 1
        c.close()
    finally:
        ps.stop()


def test_native_join_drain_protocol_parity():
    """The C++ core speaks JOIN/DRAIN (actions 12/13) with the Python PS's
    accounting and stats key set, and counts the same sequence as the JAX
    package's native core: the pool gauge moves in the core itself."""
    from distkeras_tpu.native_ps import NativePSClient as JClient
    from distkeras_tpu.native_ps import (
        NativeSocketParameterServer as JServer,
    )
    from tests.test_torch_pipeline import _jax_native

    native.load_dkps()
    from distkeras_tpu_torch.native_ps import (
        NativePSClient,
        NativeSocketParameterServer,
    )

    _jax_native()
    center = {"w": np.zeros(4, np.float32)}
    runs = []
    for server_cls, client_cls, rule in (
            (NativeSocketParameterServer, NativePSClient,
             tr.DownpourMerge()),
            (JServer, JClient, jr.DownpourMerge())):
        ps = server_cls(center, rule, 2)
        ps.initialize()
        ps.start()
        clients: dict = {}
        try:
            def client(w, ps=ps, client_cls=client_cls):
                if w not in clients:
                    clients[w] = client_cls("127.0.0.1", ps.port, w, ps.spec)
                return clients[w]

            rec = client(6).join()
            assert rec["pool_size"] == 3 and rec["num_updates"] == 0
            assert ps.stats()["heartbeats"] == 0      # a quiet admission
            client(6).commit(6, {"w": np.ones(4, np.float32)}, seq=1)
            client(6).drain(timeout=False)
            s = ps.stats()
            assert _membership(s) == (2, 1, 1, 0)
            py = tps.ParameterServer(center, tr.DownpourMerge(), 2)
            assert set(s) == set(py.stats())          # key-set parity
            runs.append(_membership_script(
                lambda w: client(w).join(),
                lambda w, to: client(w).drain(timeout=to), ps.stats))
        finally:
            for c in clients.values():
                c.close()
            ps.stop()
    assert runs[0] == runs[1]


def test_joiner_dynsgd_tau_priced_from_join_pull_never_zero_version():
    """The joiner pulls at join, so its first commit is priced at the true
    small τ, not at the fold count a worker that never pulled pays (the
    same centers as the JAX package's, bit for bit)."""
    outs = []
    for mod, rule in ((tps, tr.DynSGDMerge), (jps, jr.DynSGDMerge)):
        ps = mod.ParameterServer({"w": np.zeros(1, np.float32)}, rule(), 2)
        for _ in range(4):                # the incumbent: center = 16
            ps.pull(0)
            ps.commit(0, {"w": np.array([4.0], np.float32)})
        ps.join_worker(1)
        ps.pull(1)                        # pull version 4
        ps.commit(1, {"w": np.array([5.0], np.float32)})   # τ 0: +5
        ps2 = mod.ParameterServer({"w": np.zeros(1, np.float32)}, rule(), 2)
        for _ in range(4):
            ps2.pull(0)
            ps2.commit(0, {"w": np.array([4.0], np.float32)})
        ps2.commit(1, {"w": np.array([5.0], np.float32)})  # τ 4: +5/5
        outs.append((ps.get_model()["w"], ps2.get_model()["w"]))
    np.testing.assert_allclose(outs[0][0], 21.0)
    np.testing.assert_allclose(outs[0][1], 17.0)
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


# -- ElasticCoordinator: the drain state machine (stub workers) ---------------


class _StubClient:
    def __init__(self):
        self.drains: list[bool] = []
        self.closed = False

    def drain(self, timeout=False):
        self.drains.append(bool(timeout))

    def close(self):
        self.closed = True


def _stub_spawn_factory(bodies):
    """spawn() over plain threads: ``bodies[wid](worker)`` is the loop."""
    threads = []

    def spawn(wid, joiner):
        class W:
            drain_event = threading.Event()
            error = None
            _windows_done = 0

        w = W()
        t = threading.Thread(target=bodies[wid], args=(w,), daemon=True)
        t.start()
        threads.append(t)
        return w, _StubClient(), t

    spawn.threads = threads
    return spawn


def test_coordinator_clean_drain_reports_and_settles():
    a = ShardAssigner(n_rows=8, window=1, batch_size=8, num_epoch=1)
    spawn = _stub_spawn_factory({0: lambda w: w.drain_event.wait(10)})
    co = ElasticCoordinator(a, spawn, drain_timeout=5.0,
                            poll_interval=0.02)
    co.start([0])
    assert co.request_preempt(0)
    assert not co.request_preempt(0)      # idempotent while draining
    co.run()
    s = co.stats()
    assert s["preempted"] == 1 and s["drain_timeouts"] == 0
    assert co.clients[0].drains == [False]
    assert not co.clients[0].closed       # the shutdown path closes it
    (d,) = s["drain_log"]
    assert d["worker"] == 0 and not d["timeout"] and d["t_done"] >= d["t"]
    assert not any(t.is_alive() for t in spawn.threads)


def test_coordinator_drain_deadline_falls_back_to_force_drain():
    a = ShardAssigner(n_rows=8, window=1, batch_size=8, num_epoch=1)
    a.claim(0)                            # the wedged worker holds a block
    unwedge = threading.Event()
    admin = _StubClient()
    spawn = _stub_spawn_factory({0: lambda w: unwedge.wait(30)})
    co = ElasticCoordinator(a, spawn, make_drain_client=lambda wid: admin,
                            drain_timeout=0.2, poll_interval=0.02)
    co.start([0])
    co.request_preempt(0)
    try:
        co.run()                          # the abandoned thread excluded
        s = co.stats()
        assert s["drain_timeouts"] == 1 and s["preempted"] == 1
        assert admin.drains == [True] and admin.closed
        assert co.clients[0].closed       # torn out from under the wedge
        assert a.oracle()["blocks_in_flight"] == 0
        assert a.claim(1) is not None
        assert s["drain_log"][0]["timeout"] is True
        # what the abandoned worker raises later is not a run failure
        co.workers[0].error = RuntimeError("post-abandon fallout")
        assert co.worker_error(co.workers[0]) is None
    finally:
        unwedge.set()
        for t in spawn.threads:
            t.join(timeout=TIMEOUT)


# -- trainer integration ------------------------------------------------------


@pytest.mark.parametrize("transport", ["inprocess", "socket", "native"])
def test_elastic_trainer_live_join_and_clean_preempt(transport):
    """A join and a preemption: the joiner trains, the drained worker
    leaves cleanly, the ledger and the pool counters agree, every logical
    commit folds once, and the run learns."""
    if transport == "native":
        native.load_dkps()
    plan = FaultPlan(seed=3, join_worker_at_window={0: 1},
                     preempt_worker_at_window={1: 1})
    t = trainers.DOWNPOUR(_spec(), **_kw(elastic=True, fault_plan=plan,
                                         ps_transport=transport,
                                         heartbeat_interval=0.1))
    _train(t, _ds(1024))
    el = t.resilience_stats_["elastic"]
    assert el["joined"] == 1 and el["preempted"] == 1
    assert el["drain_timeouts"] == 0
    assert el["assigner"]["exactly_once"], el["assigner"]
    assert el["join_log"][0]["reason"] == "fault_plan"
    s = t.ps_stats_
    assert _membership(s) == (2, 1, 1, 0)  # 2 + 1 join - 1 drain
    assert s["commits"] == t.resilience_stats_["logical_commits"] == \
        el["assigner"]["blocks_total"]
    assert 2 in _workers_seen(t)           # the joiner trained
    assert epoch_mean_loss(t, 1) < 0.6


def test_elastic_trainer_live_join_and_clean_preempt_shm():
    """The elastic loop over the shm rings: joiners' ring pairs minted
    mid-run, a clean drain, the ledger exact."""
    plan = FaultPlan(seed=3, join_worker_at_window={0: 1},
                     preempt_worker_at_window={1: 1})
    t = trainers.DOWNPOUR(_spec(), **_kw(elastic=True, fault_plan=plan,
                                         ps_transport="shm",
                                         heartbeat_interval=0.1))
    _train(t, _ds(1024))
    el = t.resilience_stats_["elastic"]
    assert el["joined"] == 1 and el["preempted"] == 1
    assert el["assigner"]["exactly_once"], el["assigner"]
    s = t.ps_stats_
    assert _membership(s) == (2, 1, 1, 0)
    assert s["commits"] == t.resilience_stats_["logical_commits"]
    assert 2 in _workers_seen(t)


def test_elastic_autoscaler_joins_toward_target():
    """An unreachable rounds/s target grows the pool through the live-join
    path, never past ``max_pool_size``."""
    policy = ElasticPolicy(target_rounds_per_sec=1e6, max_workers=3,
                           cooldown_s=0.0)
    t = trainers.DOWNPOUR(_spec(), **_kw(elastic=True,
                                         autoscale_target=policy,
                                         max_pool_size=3))
    _train(t, _ds(2048))
    el = t.resilience_stats_["elastic"]
    assert 1 <= el["joined"] <= 1 + el["preempted"]
    assert any(d["reason"] == "under_target"
               for d in el["policy_decisions"])
    assert all(j["reason"] == "autoscaler" for j in el["join_log"])
    assert el["assigner"]["exactly_once"]
    assert t.ps_stats_["joined_workers"] == el["joined"]


def test_elastic_resume_reconciles_with_warn_elastic_resume(tmp_path):
    """An elastic trainer resuming any checkpoint takes the elastic path
    (the center carries over, fresh per-worker state, the warning) and
    trains only the remaining epochs, exactly once; an elastic run writes
    no barrier checkpoint."""
    ds = _ds(512)
    t1 = trainers.DOWNPOUR(_spec(), **_kw(num_epoch=1,
                                          checkpoint_dir=str(tmp_path)))
    _train(t1, ds)
    t2 = trainers.DOWNPOUR(_spec(), **_kw(num_workers=4, num_epoch=2,
                                          elastic=True,
                                          checkpoint_dir=str(tmp_path),
                                          resume=True))
    with pytest.warns(UserWarning, match="elastic resume"):
        _watchdog(lambda: t2.train(ds, shuffle=True))
    el = t2.resilience_stats_["elastic"]
    assert el["assigner"]["epochs"] == 1
    assert el["assigner"]["exactly_once"]
    assert {r["epoch"] for r in t2.get_history() if "loss" in r} == {1}
    t3 = trainers.DOWNPOUR(_spec(), **_kw(elastic=True, num_epoch=1,
                                          checkpoint_dir=str(tmp_path)))
    with pytest.warns(UserWarning, match="resume-only"):
        _watchdog(lambda: t3.train(ds, shuffle=True))


def test_elastic_knob_validation():
    with pytest.raises(ValueError, match="backend='ps'"):
        trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", num_workers=2, device="cpu",
                      elastic=True)
    with pytest.raises(ValueError, match="autoscale_target requires"):
        trainers.ADAG(_spec(), **_kw(autoscale_target=10.0))
    with pytest.raises(ValueError, match="max_pool_size requires"):
        trainers.ADAG(_spec(), **_kw(max_pool_size=4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainers.ADAG(_spec(), **_kw(elastic=True, worker_restart_budget=1))
    with pytest.raises(ValueError, match="preempt_drain_timeout"):
        trainers.ADAG(_spec(), **_kw(elastic=True, preempt_drain_timeout=0))
    with pytest.raises(ValueError, match="must be >= num_workers"):
        trainers.ADAG(_spec(), **_kw(elastic=True, max_pool_size=1))
    with pytest.raises(ValueError, match="must be positive"):
        trainers.ADAG(_spec(), **_kw(elastic=True, autoscale_target=0))
    with pytest.raises(ValueError, match="ps_host"):
        trainers.ADAG(_spec(), **_kw(elastic=True, ps_transport="socket",
                                     ps_host="127.0.0.1"))
    # the pipelined exchange refuses checkpoint_dir, except when elastic
    # (no barrier is taken there)
    with pytest.raises(ValueError, match="ps_pipeline_depth"):
        trainers.ADAG(_spec(), **_kw(ps_pipeline_depth=1,
                                     checkpoint_dir="/x"))
    trainers.ADAG(_spec(), **_kw(ps_pipeline_depth=1, checkpoint_dir="/x",
                                 elastic=True))
    plan = FaultPlan(join_worker_at_window={0: 1})
    t = trainers.ADAG(_spec(), **_kw(fault_plan=plan))
    with pytest.raises(ValueError, match="join/preempt"):
        t.train(_ds(512), shuffle=True)


@pytest.mark.parametrize("cls_name,shards", [
    ("ADAG", 1), ("DOWNPOUR", 2), ("DynSGD", 1),
])
def test_elastic_chaos_converges_exactly_once(cls_name, shards, tmp_path):
    """Under a seeded mid-run join and preemption plus wire drops and
    delays, over the socket PS with a WAL (two shards on the DOWNPOUR
    leg): the run completes, its last epoch beats a clean run's first,
    every example trains once an epoch, and every logical commit folds
    once on every shard."""
    cls = getattr(trainers, cls_name)
    ds = _ds(1024)
    base = cls(_spec(), **_kw())
    _train(base, ds)
    first_epoch = epoch_mean_loss(base, 0)
    plan = FaultPlan(seed=13, drop_recv=0.03, delay=0.03, delay_s=0.002,
                     max_faults=40, join_worker_at_window={0: 1},
                     preempt_worker_at_window={1: 1})
    t = cls(_spec(), **_kw(
        ps_transport="socket", ps_num_shards=shards,
        ps_wal_dir=str(tmp_path / "wal"), elastic=True, fault_plan=plan,
        retry_policy=RetryPolicy(base_delay=0.005, max_delay=0.1,
                                 deadline=60),
        heartbeat_interval=0.05))
    with plan:
        _train(t, ds)
    st = plan.stats()
    assert st["joins"] == 1 and st["preempts"] == 1
    assert st["drops"] > 0
    rs = t.resilience_stats_
    el = rs["elastic"]
    assert el["joined"] == 1 and el["preempted"] == 1
    assert el["drain_timeouts"] == 0
    assert epoch_mean_loss(t, 1) < first_epoch
    assert el["assigner"]["exactly_once"], el["assigner"]
    s = t.ps_stats_
    assert s["num_updates"] == rs["logical_commits"]
    if shards > 1:
        assert s["num_updates"] == s["num_updates_max"]
        for shard in s["per_shard"]:
            assert (shard["joined_workers"],
                    shard["preempted_workers"]) == (1, 1)
    assert s["joined_workers"] == 1 and s["preempted_workers"] == 1
    assert s["drain_timeouts"] == 0
    assert 2 in _workers_seen(t)


# -- the pipelined elastic loop and the elastic rules' drain ------------------


@pytest.mark.parametrize("transport", ["inprocess", "native"])
def test_pipelined_elastic_exactly_once_under_membership_chaos(transport):
    """Depth 1: a block is confirmed on its deferred exchange's ACK, and
    the ledger survives a live join and a drain; every exchange is
    fused."""
    if transport == "native":
        native.load_dkps()
    plan = FaultPlan(seed=7, join_worker_at_window={0: 1},
                     preempt_worker_at_window={1: 1})
    t = trainers.ADAG(_spec(), **_kw(elastic=True, ps_pipeline_depth=1,
                                     fault_plan=plan, ps_transport=transport,
                                     preempt_drain_timeout=30.0))
    _train(t, _ds(512), shuffle=False)
    el = t.resilience_stats_["elastic"]
    assert el["joined"] == 1 and el["preempted"] == 1
    assert el["drain_timeouts"] == 0
    assert el["assigner"]["exactly_once"], el["assigner"]
    s = t.ps_stats_
    assert s["fused_exchanges"] == s["commits"] == \
        el["assigner"]["blocks_total"]
    assert _membership(s) == (2, 1, 1, 0)
    assert np.isfinite(epoch_mean_loss(t, 1))


def test_easgd_clean_drain_commits_final_elastic_difference(monkeypatch):
    """A cleanly drained elastic-rule worker commits its final elastic
    difference before it deregisters: the center ends at ``c + α·(w −
    c)``, bit for bit against the worker's stashed final state."""
    created = []
    orig_init = tworkers.AsyncWorker.__init__

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        created.append(self)

    monkeypatch.setattr(tworkers.AsyncWorker, "__init__", spy_init)
    plan = FaultPlan(seed=1, preempt_worker_at_window={0: 2})
    t = trainers.AEASGD(_spec(), **_kw(rho=0.5, num_workers=1,
                                       communication_window=2, num_epoch=4,
                                       elastic=True, fault_plan=plan,
                                       preempt_drain_timeout=30.0))
    weights = _train(t, _ds(512), shuffle=False)
    drained = [w for w in created if hasattr(w, "drained_center_")]
    assert len(drained) == 1
    w = drained[0]
    rule = t.allocate_merge_rule()
    diff = rule.worker_commit(w.final_params_, w.drained_center_)
    expected = rule.fold(w.drained_center_, diff, 1, 0)
    for k, v in weights.items():
        np.testing.assert_array_equal(v.numpy(), expected[k])
    hist = [r for r in t.get_history() if "loss" in r]
    assert t.ps_stats_["commits"] == len(hist) + 1
    assert t.resilience_stats_["elastic"]["preempted"] == 1


# -- the sharded center -------------------------------------------------------


def test_sharded_live_join_exactly_once_per_shard():
    """A live join against a 2-shard group: the joiner's fan-out client
    passes the shard-map check on every shard, its join registers on
    every shard's pool, its commits fold once a shard, and its drain
    retires its seqno on every shard."""
    tree = _model_tree(seed=3)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DownpourMerge(), 1,
                           num_shards=2, transport="socket")
    group.initialize()
    group.start()
    c0 = group.make_client(0, resilient=True)
    c1 = None
    try:
        for _ in range(3):
            c0.pull()
            c0.commit(0, _full(tree, 0.1))
        c1 = group.make_client(1, resilient=True)
        c1.verify_shard_map()
        assert c1.join()["pool_size"] == 2
        c1.pull()
        for _ in range(2):
            c1.pull()
            c1.commit(1, _full(tree, 0.1))
        s = group.stats()
        assert s["pool_size"] == 2 and s["joined_workers"] == 1
        assert s["num_updates"] == s["num_updates_max"] == 5
        assert c0.seq == 3 and c1.seq == 2
        c1.drain(timeout=False)
        s = group.stats()
        assert s["preempted_workers"] == 1 and s["pool_size"] == 1
        for srv in group.servers:
            assert 1 not in srv._last_seq
    finally:
        c0.close()
        if c1 is not None:
            c1.close()
        group.stop()


# -- across packages: one elastic run -----------------------------------------


def test_one_worker_elastic_run_matches_the_jax_package():
    """One DOWNPOUR worker, elastic, shuffled, from the same initial
    weights: both assigners draw the same rows, so the losses agree within
    rtol 1e-6 and the centers within 1e-5 absolute (f32)."""
    x, y = blobs(n=512)
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(4)   # the trainers' seed: their init, their rows
    tspec = _spec()
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=1, batch_size=16,
              communication_window=4, num_epoch=2, backend="ps",
              elastic=True, seed=4)
    jt = jdk.DOWNPOUR(jspec, **kw)
    jcenter = jt.train(jdata.Dataset.from_arrays(x, y), shuffle=True)
    tt = trainers.DOWNPOUR(tspec, device="cpu", **kw)
    tcenter = _train(tt, Dataset.from_arrays(x, y))
    assert len(tt.history.losses()) == 2 * 512 // 64
    assert tt.resilience_stats_["elastic"]["assigner"] == \
        jt.resilience_stats_["elastic"]["assigner"]
    np.testing.assert_allclose(tt.history.losses(), jt.history.losses(),
                               rtol=1e-6)
    back = params_to_jax(tcenter, tspec.module)
    for a, b in zip(jax.tree.leaves(jcenter), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)
    assert torch.is_tensor(next(iter(tcenter.values())))
