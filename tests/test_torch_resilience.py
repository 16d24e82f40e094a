"""The port's resilience layer (``distkeras_tpu_torch/resilience/``: faults,
heartbeats, retries with exactly-once commit dedup, worker recovery) held
against the JAX package's on the CPU.

The oracles are ``tests/test_resilience.py``'s: under injected drops,
delays and worker kills a PS run completes, learns, and folds every
logical commit exactly once (``ps_stats_["commits"] ==
resilience_stats_["logical_commits"]``). Across packages, with the same
seeds and the same scripted inputs: ``RetryPolicy`` delay sequences,
``FaultPlan`` decisions and ``WorkerRegistry`` evictions (under a fake
clock) are equal, the PS's dedup and lease bookkeeping gives bit-equal
centers (tolerance 0: the center is host numpy on both sides), and each
package's client speaks to the other's server (seq dedup, fencing,
heartbeat, deregister).

No test waits on a fixed sleep that races: leases expire under injected
clocks, sockets carry timeouts, threads are joined with a timeout, and a
training run runs under a watchdog. Assertions are on invariants (exactly
once, bit equality, convergence below a loose bound), never on counts
that depend on timing.
"""

import socket
import struct
import threading
import time
import warnings

import numpy as np
import pytest

from distkeras_tpu import networking as jnet
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu import resilience as jres
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import networking as tnet
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch import resilience as tres
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch import workers as tworkers
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.parallel import merge_rules as tr
from tests.test_torch_ps import TIMEOUT, _final_loss, _join, _spec, blobs

#: the training runs' watchdog (seconds)
RUN_LIMIT = 120.0


def _watchdog(fn, limit: float = RUN_LIMIT):
    """Run ``fn`` in a thread joined with ``limit``: a hang fails the test
    instead of the suite. Returns ``fn``'s result, re-raises its error."""
    out: dict = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:   # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout=limit)
    assert not t.is_alive(), f"run still going after {limit} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fake_lease(ps, pkg, lease: float, clock):
    """Swap a server's lease registry for one on ``clock`` (same timeout,
    same eviction callback)."""
    ps._registry = pkg.WorkerRegistry(lease, clock=clock,
                                      on_evict=ps._on_evict)


# -- networking ---------------------------------------------------------------


def test_protocol_error_mid_frame_is_retryable_with_context():
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    a.sendall(struct.pack(">Q", 100) + b"x" * 10)
    a.close()
    with pytest.raises(tnet.ProtocolError) as ei:
        tnet.recv_data(b)
    assert ei.value.retryable is True and ei.value.frame_size == 100
    b.close()


def test_fault_plan_installs_on_the_ports_module_alone():
    """A port ``FaultPlan`` hooks the port's ``networking`` and never the
    JAX package's (and the other way round); uninstall clears only its
    own seam."""
    plan = tres.FaultPlan(seed=0)
    with plan:
        assert tnet._fault_hook == plan._wire
        assert jnet._fault_hook is None
        with pytest.raises(RuntimeError, match="already installed"):
            tres.FaultPlan(seed=1).install()
        jplan = jres.FaultPlan(seed=0)
        with jplan:   # the JAX package's seam is its own
            assert jnet._fault_hook == jplan._wire
            assert tnet._fault_hook == plan._wire
        assert jnet._fault_hook is None
    assert tnet._fault_hook is None and jnet._fault_hook is None
    # the seam really is on the port's wire: a drop plan tears a frame
    a, b = socket.socketpair()
    try:
        with tres.FaultPlan(seed=0, drop_send=1.0):
            with pytest.raises(tres.FaultInjectedError):
                tnet.send_data(a, {"x": 1})
            jnet.send_data(a, {"x": 1})   # the JAX wire is untouched
    finally:
        a.close()
        b.close()


# -- RetryPolicy ---------------------------------------------------------------


@pytest.mark.parametrize("seed,salt", [(0, 0), (42, 7), (3, (5 << 32) ^ 9)])
def test_retry_policy_delays_equal_the_jax_package(seed, salt):
    """Same seed and salt, same jittered exponential delays, bit for bit;
    jitter only ever scales down."""
    kw = dict(base_delay=0.1, max_delay=1.0, jitter=0.5, seed=seed)
    a = tres.RetryPolicy(**kw).delays(salt)
    b = jres.RetryPolicy(**kw).delays(salt)
    da = [a.next_delay() for _ in range(12)]
    assert da == [b.next_delay() for _ in range(12)]
    for k, got in enumerate(da):
        raw = min(0.1 * 2 ** k, 1.0)
        assert 0.5 * raw <= got <= raw


def test_retry_policy_triage_and_deadline():
    assert tres.is_retryable(ConnectionResetError("peer died"))
    assert tres.is_retryable(tnet.ProtocolError("torn", retryable=True))
    assert not tres.is_retryable(tnet.ProtocolError("cap", retryable=False))
    assert not tres.is_retryable(tnet.FencedEpochError("fenced"))
    assert not tres.is_retryable(ValueError("a bug"))
    calls = []

    def flaky():
        calls.append(1)
        raise ConnectionError("down")

    p = tres.RetryPolicy(max_attempts=3, base_delay=0.001, deadline=10.0)
    with pytest.raises(tres.RetryDeadlineExceeded):
        p.run(flaky)
    assert len(calls) == 3
    calls.clear()

    def buggy():
        calls.append(1)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        p.run(buggy)
    assert len(calls) == 1
    t = [0.0]

    def sleep(s):
        t[0] += s

    slow = tres.RetryPolicy(max_attempts=100, base_delay=1.0, max_delay=1.0,
                            deadline=2.5, jitter=0.0)
    with pytest.raises(tres.RetryDeadlineExceeded, match="deadline"):
        slow.run(flaky, clock=lambda: t[0], sleep=sleep)


# -- FaultPlan -----------------------------------------------------------------


def _decisions(plan, ops):
    out = []
    for op in ops:
        try:
            plan._wire(op, None)
            out.append(False)
        except (tres.FaultInjectedError, jres.FaultInjectedError):
            out.append(True)
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=7, drop_recv=0.3),
    dict(seed=8, drop_send=0.2, drop_recv=0.1, max_faults=5),
    dict(seed=0, partition_after=3, partition_ops=4, drop_send=0.05),
], ids=["recv", "both-capped", "partition"])
def test_fault_plan_decisions_equal_the_jax_package(kw):
    """Same seed, same op sequence: the same drops, partitions and delay
    draws, and the same stats."""
    ops = ["send", "recv", "recv", "send"] * 24
    a, b = tres.FaultPlan(**kw), jres.FaultPlan(**kw)
    da = _decisions(a, ops)
    assert da == _decisions(b, ops)
    assert any(da) and not all(da)
    assert a.stats() == b.stats()
    if "max_faults" in kw:
        assert a.stats()["drops"] <= kw["max_faults"]


def test_fault_plan_worker_and_ps_decisions_equal_the_jax_package():
    """Kills fire once at their window (a restarted worker replays the
    index unharmed), the PS kill once past its threshold, in both
    packages alike; a plan's elastic and directory events are reported as
    the JAX package reports them."""
    for pkg in (tres, jres):
        plan = pkg.FaultPlan(kill_at={1: 3}, kill_ps_after_commits=5)
        plan.maybe_kill(1, 2)
        plan.maybe_kill(0, 3)
        with pytest.raises(pkg.WorkerKilled, match="worker 1 at window 3"):
            plan.maybe_kill(1, 3)
        plan.maybe_kill(1, 3)
        assert [plan.should_kill_ps(v) for v in (4, 5)] == [False, True]
        plan.note_ps_kill()
        assert not plan.should_kill_ps(9)
        assert (plan.stats()["kills"], plan.stats()["ps_kills"]) == (1, 1)
    for kw in (dict(join_worker_at_window={0: 1}),
               dict(kill_directory_after_ops=3)):
        assert (tres.FaultPlan(**kw).has_elastic_events
                == jres.FaultPlan(**kw).has_elastic_events)
        assert (tres.FaultPlan(**kw).has_directory_events
                == jres.FaultPlan(**kw).has_directory_events)


# -- WorkerRegistry ---------------------------------------------------------------


def _registry_script(pkg):
    clock = _Clock()
    evicted: list = []
    reg = pkg.WorkerRegistry(lease_timeout=10.0, clock=clock,
                             on_evict=evicted.extend)
    out = [reg.renew(0), reg.renew(0, retries=2), reg.renew(1),
           reg.active()]
    clock.t = 8.0
    reg.renew(1)
    clock.t = 12.0
    out += [reg.expire(), list(evicted), reg.stats(), reg.renew(0)]
    reg.renew(0, retries=3)
    reg.register(2)
    out.append(reg.stats())
    reg.deregister(1)
    clock.t = 100.0
    out += [reg.expire(), reg.expire(force=True), reg.stats(),
            list(evicted)]
    return out


def test_registry_evictions_equal_the_jax_package():
    """A scripted lease life (renew, re-admission after eviction, a quiet
    register, a clean deregister, the rate-limited and forced expiry) on a
    fake clock: the same answers, evictions and stats in both."""
    got = _registry_script(tres)
    assert got == _registry_script(jres)
    assert got[4] == [0] and got[6]["worker_retries"] == 2
    assert got[8]["worker_retries"] == 3     # max per id: no double count


def _evict_then_zombie(pkg_ps, pkg_res, rules):
    center = {"w": np.zeros(3, np.float32)}
    ps = pkg_ps.ParameterServer(center, rules.DynSGDMerge(), 3,
                                lease_timeout=1.0)
    clock = _Clock()
    _fake_lease(ps, pkg_res, 1.0, clock)
    ps.pull(0)
    ps.heartbeat(0)
    for k in range(4):
        ps.pull(1)
        ps.commit(1, {"w": np.full(3, 4.0 + k, np.float32)}, seq=k + 1)
    clock.t = 5.0
    s = ps.stats()
    evicted_state = (0 in ps._pull_versions, 0 in ps._last_seq)
    # the zombie's commit: τ = num_updates, not its stale pull's τ
    ps.commit(0, {"w": np.array([5.0, -1.0, 0.5], np.float32)}, seq=1)
    return ps.get_model(), s["evicted_workers"], evicted_state


def test_ps_eviction_feeds_dynsgd_staleness():
    """An evicted worker's pull version and dedup entry are forgotten: its
    zombie commit folds priced at τ = num_updates (scale 1/5), the same
    bits in both packages."""
    tc, tev, tstate = _evict_then_zombie(tps, tres, tr)
    jc, jev, jstate = _evict_then_zombie(jps, jres, jr)
    _tree_equal(tc, jc)
    assert tev == jev == 1 and tstate == jstate == (False, False)
    np.testing.assert_array_equal(
        tc["w"], np.float32(4 + 5 + 6 + 7)
        + np.array([5.0, -1.0, 0.5], np.float32) * np.float32(1 / 5))


def _lapse_then_replay(pkg_ps, pkg_res, rules):
    """Worker 0's window outlasts its lease; its commit folds, the ACK is
    lost, worker 1's heartbeat runs the expiry scan, and the commit is
    replayed with the same seq."""
    ps = pkg_ps.ParameterServer({"w": np.zeros(2, np.float32)},
                                rules.DownpourMerge(), 2, lease_timeout=1.0)
    clock = _Clock()
    _fake_lease(ps, pkg_res, 1.0, clock)
    ps.heartbeat(0)
    ps.heartbeat(1)
    clock.t = 1.5
    d = {"w": np.ones(2, np.float32)}
    verdicts = [ps.commit(0, d, seq=1)]
    clock.t = 1.6
    ps.heartbeat(1)                      # the scan
    verdicts.append(ps.commit(0, d, seq=1))
    return verdicts, ps.num_updates, ps.stats()["evicted_workers"]


def test_a_lapsed_lease_does_not_fold_a_replay_twice():
    """The reference's fault (``ROADMAP.md`` queue C): a worker's lease is
    renewed only by its heartbeats, so a window longer than the lease lets
    the scan evict it between a fold and the replay of its lost ACK; the
    eviction retires its dedup entry and the replay folds twice. The port
    extends a leased worker's lease on each of its requests: the replay is
    refused and the commit folds once."""
    assert _lapse_then_replay(jps, jres, jr) == ([True, True], 2, 1)
    assert _lapse_then_replay(tps, tres, tr) == ([True, False], 1, 0)


# -- seqno dedup --------------------------------------------------------------


def _dedup_script(ps):
    d = {"w": np.arange(2, dtype=np.float32) + 0.5}
    verdicts = [ps.commit(0, d, seq=1), ps.commit(0, d, seq=1),
                ps.commit(0, d, seq=2), ps.commit(0, d),
                ps.commit(1, d, seq=1)]
    ps.deregister_worker(0)
    verdicts.append(ps.commit(0, d, seq=1))   # a fresh generation
    return verdicts


def test_seqno_dedup_inprocess_equals_the_jax_package():
    """Replays refused, seq-less commits fold, a deregister retires the
    dedup entry: the same verdicts, centers and counters in both."""
    t = tps.ParameterServer({"w": np.zeros(2, np.float32)},
                            tr.DownpourMerge(), 2)
    j = jps.ParameterServer({"w": np.zeros(2, np.float32)},
                            jr.DownpourMerge(), 2)
    assert _dedup_script(t) == _dedup_script(j) == \
        [True, False, True, True, True, True]
    _tree_equal(t.get_model(), j.get_model())
    ts, js = t.stats(), j.stats()
    for k in ("commits", "dup_commits", "num_updates", "fenced_commits"):
        assert ts[k] == js[k], k
    assert ts["dup_commits"] == 1


def _server(pkg, center, rule, n, **kw):
    ps = pkg.SocketParameterServer(center, rule, n, **kw)
    ps.initialize()
    ps.start()
    return ps


def _client(pkg, port, wid, **kw):
    if pkg is tps:
        return tps.ParameterServerClient("127.0.0.1", port, wid,
                                         timeout=TIMEOUT, **kw)
    c = jps.ParameterServerClient("127.0.0.1", port, wid, **kw)
    c._sock.settimeout(TIMEOUT)
    return c


def _wire_script(server_pkg, client_pkg, rules):
    """Dedup, fencing, heartbeat, deregister and the fence action over
    the wire; returns what each step answered and the server's end
    state."""
    ps = _server(server_pkg, {"w": np.zeros(4, np.float32)},
                 rules.DownpourMerge(), 2)
    out = []
    try:
        c = _client(client_pkg, ps.port, 0, epoch=0)
        d = {"w": np.linspace(-1, 1, 4).astype(np.float32)}
        c.commit(0, d, seq=1)
        c.commit(0, d, seq=1)                 # replay: refused
        out.append(c.exchange(0, d, seq=2)["w"].tolist())
        out.append(c.exchange(0, d, seq=2)["w"].tolist())   # dup + pull
        out += [c.heartbeat(retries=3), c.heartbeat(retries=3)]
        out.append(c.fence(2))
        with pytest.raises((tnet.FencedEpochError, jnet.FencedEpochError)):
            c.commit(0, d, seq=3)
        with pytest.raises((tnet.FencedEpochError, jnet.FencedEpochError)):
            c.exchange(0, d, seq=3)
        c.epoch = 2
        c.commit(0, d, seq=3)
        c.deregister()
        c.close()
        s = ps.stats()
        out.append({k: s[k] for k in (
            "commits", "dup_commits", "fenced_commits", "num_updates",
            "heartbeats", "worker_retries", "active_workers",
            "evicted_workers")})
        out.append(ps.get_model()["w"].tolist())
        out.append(dict(ps._last_seq))
    finally:
        ps.stop()
    return out


@pytest.mark.parametrize("direction", ["port_client_jax_server",
                                       "jax_client_port_server"])
def test_dedup_and_fencing_over_the_wire_across_packages(direction):
    """Each package's client against the other's server answers as the
    same-package pair does, step for step and bit for bit: seq dedup on
    commit and exchange, the fence action, fenced commits and exchanges
    (a typed error), heartbeat and deregister."""
    if direction == "port_client_jax_server":
        got = _wire_script(jps, tps, jr)
        want = _wire_script(jps, jps, jr)
    else:
        got = _wire_script(tps, jps, tr)
        want = _wire_script(tps, tps, tr)
    assert got == want
    stats = got[-3]
    assert (stats["commits"], stats["dup_commits"],
            stats["fenced_commits"]) == (3, 2, 2)
    assert got[2:5] == [False, True, 2]


# -- the resilient client ----------------------------------------------------------


def test_resilient_client_replays_lost_acks_exactly_once():
    """The inner commit succeeds server-side, then its ack dies: the
    retry re-sends the same seq and the server folds once."""
    ps = tps.ParameterServer({"w": np.zeros(3, np.float32)},
                             tr.DownpourMerge(), 1)
    lose = [3]

    class Lossy(tworkers._BoundPS):
        def commit(self, worker_id, payload, seq=None):
            super().commit(worker_id, payload, seq=seq)
            if lose[0] > 0:
                lose[0] -= 1
                raise tres.FaultInjectedError("ack lost after apply")

    c = tres.ResilientPSClient(
        lambda: Lossy(ps, 0), 0,
        policy=tres.RetryPolicy(base_delay=0.001, max_delay=0.01,
                                deadline=10))
    for _ in range(5):
        c.commit(0, {"w": np.ones(3, np.float32)})
    c.heartbeat()
    s = ps.stats()
    assert c.seq == 5 and ps.num_updates == s["commits"] == 5
    assert s["dup_commits"] == 3 and s["worker_retries"] == c.retries == 3
    np.testing.assert_array_equal(ps.get_model()["w"], 5.0)


def test_fresh_client_seqnos_survive_a_long_lived_ps():
    """A new run's client against a long-lived PS: its epoch-based wire
    seqnos are never swallowed by the previous run's dedup entries."""
    ps = tps.ParameterServer({"w": np.zeros(1, np.float32)},
                             tr.DownpourMerge(), 1)
    for _ in range(2):
        c = tres.ResilientPSClient(lambda: tworkers._BoundPS(ps, 0), 0)
        for _ in range(3):
            c.commit(0, {"w": np.ones(1, np.float32)})
    assert ps.num_updates == 6 and ps.stats()["dup_commits"] == 0


def test_resilient_client_reconnects_through_server_side_drops():
    """Real wire, seeded drops on both sides: the clients reconnect, and
    the folds stay exactly-once."""
    ps = _server(tps, {"w": np.zeros(4, np.float32)}, tr.DownpourMerge(), 2,
                 lease_timeout=30.0)
    plan = tres.FaultPlan(seed=5, drop_recv=0.15, max_faults=30)
    clients = [tres.ResilientPSClient(
        lambda i=i: _client(tps, ps.port, i), i,
        policy=tres.RetryPolicy(max_attempts=100, base_delay=0.005,
                                max_delay=0.05, deadline=30),
        heartbeat_interval=0.01) for i in range(2)]
    errors = []

    def worker(i):
        try:
            for _ in range(20):
                clients[i].pull()
                clients[i].commit(i, {"w": np.full(4, 0.5, np.float32)})
                clients[i].maybe_heartbeat()
        except BaseException as e:
            errors.append(e)

    try:
        with plan:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            _join(threads)
        assert not errors, errors
        s = ps.stats()
        assert sum(c.seq for c in clients) == 40
        assert ps.num_updates == s["commits"] == 40
        np.testing.assert_array_equal(ps.get_model()["w"], 20.0)
        assert plan.stats()["drops"] > 0 and s["heartbeats"] > 0
        for c in clients:
            c.close()
    finally:
        ps.stop()


# -- worker recovery ------------------------------------------------------------


_KW = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
           learning_rate=0.05, num_workers=4, batch_size=16,
           communication_window=2, num_epoch=2, backend="ps", device="cpu")


def test_supervisor_restarts_dead_worker_to_completion(monkeypatch):
    """``worker_restart_budget``: a worker that dies once is relaunched
    (a new thread, a fresh center pull) and the run completes with every
    worker contributing."""
    orig = tworkers.AsyncWorker._train
    died = []

    def dying_once(self, *args):
        if self.worker_id == 1 and not died:
            died.append(threading.current_thread())
            raise RuntimeError("transient death")
        assert threading.current_thread() not in died
        return orig(self, *args)

    monkeypatch.setattr(tworkers.AsyncWorker, "_train", dying_once)
    t = trainers.DOWNPOUR(_spec(), **dict(_KW, num_workers=4),
                          worker_restart_budget=2)
    with pytest.warns(UserWarning, match="restart 1/2"):
        _watchdog(lambda: t.train(Dataset.from_arrays(*blobs(n=512))))
    assert {r["worker"] for r in t.history.records if "loss" in r} == \
        {0, 1, 2, 3}
    assert t.resilience_stats_["restarts"] == 1
    assert _final_loss(t) < 0.6


def test_supervisor_budget_exhaustion_defers_to_tolerance(monkeypatch):
    """Past its budget a death is fatal (``RestartBudgetExceeded`` with the
    death as its cause) unless ``tolerate_worker_failures`` lets the
    survivors finish."""
    orig = tworkers.AsyncWorker._train

    def always_dying(self, *args):
        if self.worker_id == 1:
            raise RuntimeError("hard death")
        return orig(self, *args)

    monkeypatch.setattr(tworkers.AsyncWorker, "_train", always_dying)
    kw = dict(_KW, num_workers=2, num_epoch=1, worker_restart_budget=1)
    ds = Dataset.from_arrays(*blobs(n=256))
    with pytest.warns(UserWarning, match="restart 1/1"):
        with pytest.raises(tres.RestartBudgetExceeded,
                           match="hard death") as ei:
            _watchdog(lambda: trainers.DOWNPOUR(_spec(), **kw).train(ds))
    assert isinstance(ei.value.__cause__, RuntimeError)
    t = trainers.DOWNPOUR(_spec(), tolerate_worker_failures=True, **kw)
    with pytest.warns(UserWarning):
        _watchdog(lambda: t.train(ds))
    assert t.resilience_stats_["restarts"] == 1
    losses = t.history.losses()
    assert losses and np.all(np.isfinite(losses))


# -- chaos: the acceptance oracle ---------------------------------------------------


def _first_epoch_loss(cls_name, ds):
    base = getattr(trainers, cls_name)(_spec(), **_KW)
    _watchdog(lambda: base.train(ds, shuffle=True))
    return float(np.mean([r["loss"] for r in base.history.records
                          if "loss" in r and r.get("epoch") == 0]))


@pytest.mark.parametrize("cls_name", ["ADAG", "DOWNPOUR"])
def test_chaos_training_converges_with_exactly_once_folds(cls_name):
    """Socket drops and delays and a worker kill with a restart budget:
    the run completes, learns below the clean run's first-epoch loss, and
    folds every logical commit exactly once."""
    ds = Dataset.from_arrays(*blobs(n=1024))
    bar = _first_epoch_loss(cls_name, ds)
    plan = tres.FaultPlan(seed=11, drop_recv=0.04, delay=0.05,
                          delay_s=0.002, kill_at={1: 3}, max_faults=60)
    t = getattr(trainers, cls_name)(
        _spec(), **_KW, ps_transport="socket",
        retry_policy=tres.RetryPolicy(max_attempts=100, base_delay=0.005,
                                      max_delay=0.1, deadline=60),
        heartbeat_interval=0.05, lease_timeout=5.0,
        worker_restart_budget=2, worker_restart_delay=0.1, fault_plan=plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the restart warning
        with plan:
            _watchdog(lambda: t.train(ds, shuffle=True))
    r, s = t.resilience_stats_, t.ps_stats_
    assert plan.stats()["kills"] == 1 and r["restarts"] == 1
    assert s["commits"] == r["logical_commits"] == s["num_updates"]
    # worker 1 ran 3 windows, died, and ran its 16 again from a fresh pull
    assert r["logical_commits"] == 4 * 16 + 3
    assert plan.stats()["drops"] > 0 and s["heartbeats"] > 0
    assert _final_loss(t) < bar, (_final_loss(t), bar)
    assert {r_["worker"] for r_ in t.history.records if "loss" in r_} == \
        {0, 1, 2, 3}


def test_native_heartbeat_and_seqno_protocol_parity():
    """The C++ transport through the port's client: dedup, leases (a
    lapsed one evicts, a deregister does not), the retry count kept
    through the eviction, and the Python PS's stats keys."""
    from distkeras_tpu_torch.native_ps import (
        NativePSClient,
        NativeSocketParameterServer,
    )

    center = {"w": np.zeros(5, np.float32)}
    ps = NativeSocketParameterServer(center, tr.DownpourMerge(), 2,
                                     lease_timeout=0.15)
    ps.initialize()
    ps.start()
    try:
        c = NativePSClient("127.0.0.1", ps.port, 0, ps.spec)
        c.set_timeout(TIMEOUT)
        d = {"w": np.ones(5, np.float32)}
        c.commit(0, d, seq=1)
        c.commit(0, d, seq=1)
        c.commit(0, d, seq=2)
        assert ps.num_updates == 2
        np.testing.assert_array_equal(ps.get_model()["w"], 2.0)
        assert c.heartbeat(retries=7) is False
        assert c.heartbeat(retries=7) is True
        s = ps.stats()
        assert (s["commits"], s["dup_commits"], s["heartbeats"],
                s["worker_retries"]) == (2, 1, 2, 7)
        deadline = time.monotonic() + TIMEOUT
        while ps.stats()["evicted_workers"] == 0:
            assert time.monotonic() < deadline, "the lease never lapsed"
            time.sleep(0.05)
        s = ps.stats()
        assert s["active_workers"] == 0 and s["worker_retries"] == 7
        c2 = NativePSClient("127.0.0.1", ps.port, 1, ps.spec)
        c2.set_timeout(TIMEOUT)
        c2.heartbeat()
        c2.deregister()
        assert ps.stats()["evicted_workers"] == 1
        py = tps.ParameterServer(center, tr.DownpourMerge(), 2)
        assert set(ps.stats()) == set(py.stats())
        c.close()
        c2.close()
    finally:
        ps.stop()


def test_resilient_training_inprocess_transport():
    """The wrapper on the in-process transport: heartbeats and seqnos end
    to end, no faults, so no replays."""
    t = trainers.DOWNPOUR(_spec(), **dict(_KW, num_workers=2),
                          retry_policy=tres.RetryPolicy(),
                          heartbeat_interval=0.05)
    _watchdog(lambda: t.train(Dataset.from_arrays(*blobs(n=512)),
                              shuffle=True))
    s = t.ps_stats_
    assert _final_loss(t) < 0.6
    assert s["heartbeats"] >= 2
    assert s["commits"] == t.resilience_stats_["logical_commits"]
    assert s["dup_commits"] == s["fenced_commits"] == 0


def test_resilience_knob_validation():
    """The reference's checks on the A7.6 knobs; a plan with elastic or
    directory events is refused (nothing would consult them); every later
    item still raises naming itself."""
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.ADAG(_spec(), device="cpu", retry_policy=tres.RetryPolicy())
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.ADAG(_spec(), device="cpu", worker_restart_budget=1)
    for kw, msg in ((dict(worker_restart_budget=-1), ">= 0"),
                    (dict(heartbeat_interval=0), "positive"),
                    (dict(lease_timeout=-1.0), "positive"),
                    (dict(ps_snapshot_every=0), "positive"),
                    (dict(ps_wal_group_window=-1), ">= 0"),
                    (dict(ps_standby=True), "ps_transport='socket'"),
                    (dict(fault_plan=tres.FaultPlan(
                        kill_ps_after_commits=3), ps_transport="socket"),
                     "recovery path"),
                    (dict(fault_plan=tres.FaultPlan(
                        kill_directory_after_ops=3)), "A7.9")):
        with pytest.raises(ValueError, match=msg):
            trainers.DynSGD(_spec(), backend="ps", device="cpu", **kw)
    t = trainers.DynSGD(_spec(), **dict(_KW, num_workers=1),
                        fault_plan=tres.FaultPlan(
                            join_worker_at_window={0: 1}))
    with pytest.raises(ValueError, match="A7.8"):
        t.train(Dataset.from_arrays(*blobs(n=256)))
    for kw, item in ((dict(ps_num_shards=2), "A7.7"),
                     (dict(elastic=True), "A7.8"),
                     (dict(directory=True), "A7.9"),
                     (dict(checkpoint_dir="/x"), "A8")):
        with pytest.raises(NotImplementedError, match=item):
            trainers.DynSGD(_spec(), backend="ps", device="cpu", **kw)
    trainers.DOWNPOUR(_spec(), backend="ps", device="cpu",
                      ps_transport="socket", ps_standby=True,
                      fault_plan=tres.FaultPlan(kill_ps_after_commits=5))
