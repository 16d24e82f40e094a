"""The port's PS durability and failover (``resilience/wal.py``, the WAL
on ``parameter_servers.py``'s fold path, fencing, the hot standby, the
native server's C++ log) held against the JAX package on the CPU.

The oracles are ``tests/test_ps_durability.py``'s, and tolerance is 0
throughout (the center is host numpy on both sides):

- **bit-identical recovery**: a PS restarted from ``(snapshot, wal)``
  holds the state a never-crashed server holds after the same events:
  center, ``num_updates``, pull versions, the dedup table, the fencing
  epoch;
- **one log format**: records encode to the same bytes in both packages,
  and a log either package's server writes (dups, a fence and an eviction
  included; torn tails and torn groups too) the other recovers to the
  same bits; the native server's C++ log replays to the same bits through
  both packages' ``recover_ps_state``; ``verify_dir`` gives both packages'
  verdict on the same directories;
- **exactly-once across failover**: lifetime folds equal the logical
  commits, whatever a crash tore mid-ACK;
- **fencing**: a superseded server refuses late folds; a client with an
  endpoint resolver re-resolves, one without dies a typed death.

No test waits on a sleep that races: crashes are injected, leases expire
under fake clocks, polls are bounded, and every thread, socket and
training run is bounded by a timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time
import warnings
import zlib

import numpy as np
import pytest

from distkeras_tpu import parameter_servers as jps
from distkeras_tpu import resilience as jres
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.resilience import wal as jwal
from distkeras_tpu_torch import networking as tnet
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch import resilience as tres
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.resilience import wal as twal
from tests.test_torch_ps import TIMEOUT, _final_loss, _spec, blobs
from tests.test_torch_resilience import (
    _KW,
    _Clock,
    _client,
    _fake_lease,
    _first_epoch_loss,
    _server,
    _tree_equal,
    _watchdog,
)

_PKG = {"port": (tps, tres, tr), "jax": (jps, jres, jr)}


def center4(n=4):
    return {"w": np.zeros(n, np.float32), "b": {"x": np.zeros(2, np.float32)}}


def delta4(v, n=4):
    return {"w": np.full(n, v, np.float32), "b": {"x": np.full(2, v,
                                                               np.float32)}}


def _randn(rng, n=4):
    return {"w": rng.standard_normal(n).astype(np.float32),
            "b": {"x": rng.standard_normal(2).astype(np.float32)}}


def _state_equal(a: dict, b: dict):
    _tree_equal(a["center"], b["center"])
    for k in ("num_updates", "pull_versions", "last_seq", "fence_epoch",
              "prev_pull_versions"):
        assert a.get(k, {}) == b.get(k, {}), k


def _live_state(ps) -> dict:
    return {"center": ps.get_model(), "num_updates": ps.num_updates,
            "pull_versions": dict(ps._pull_versions),
            "prev_pull_versions": dict(ps._prev_pull_versions),
            "last_seq": dict(ps._last_seq), "fence_epoch": ps.fence_epoch}


# -- the record format ------------------------------------------------------------


def test_wal_record_bytes_equal_the_jax_package():
    """``encode_record`` and ``encode_commit_chunks`` give the same bytes
    in both packages for every record type, and both read a torn or
    corrupt tail to the same durable prefix."""
    recs = [(twal.REC_PULL, (1, 5)), (twal.REC_DEREG, (2,)),
            (twal.REC_EVICT, ([3, 4],)), (twal.REC_FENCE, (7,)),
            (twal.REC_EPOCH, (1,))]
    data = b""
    for rec_type, body in recs:
        t, j = twal.encode_record(rec_type, body), jwal.encode_record(
            rec_type, body)
        assert t == j
        data += t
    payload = np.arange(9, dtype=np.float32).tobytes()
    for seq in (9, None):
        for rec_type in (twal.REC_COMMIT2, twal.REC_COMMIT_WIRE):
            args = (3, seq, 2, 7, payload, zlib.adler32(payload))
            t = twal.encode_commit_chunks(*args, rec_type=rec_type)
            assert t == jwal.encode_commit_chunks(*args, rec_type=rec_type)
            data += b"".join(t)
    assert list(twal.iter_records(data)) == list(jwal.iter_records(data))
    for bad in (data[:-3], data[:-40],
                data[:10] + bytes([data[10] ^ 0xFF]) + data[11:]):
        assert twal.durable_prefix_len(bad) == jwal.durable_prefix_len(bad)
        assert [r[0] for r in twal.iter_records(bad)] == \
            [r[0] for r in jwal.iter_records(bad)]


def test_wal_split_checksum_commit_framing():
    """The split-checksum commit: a torn or corrupt payload, or a corrupt
    prefix, kills the record; a clean one round-trips (seq None as -1)."""
    payload = b"p" * 1000
    head, pay = twal.encode_commit_chunks(3, 9, 2, 7, payload,
                                          zlib.adler32(payload))
    data = head + pay
    assert list(twal.iter_records(data)) == [
        (twal.REC_COMMIT2, (3, 9, 2, 7, payload))]
    h2, p2 = twal.encode_commit_chunks(1, None, 0, 1, payload,
                                       zlib.adler32(payload))
    assert list(twal.iter_records(h2 + p2))[0][1][1] is None
    torn = data[:-3] + twal.encode_record(twal.REC_PULL, (0, 0))
    assert list(twal.iter_records(torn)) == []
    for off in (twal._HDR.size + twal._CMT2.size + 5, twal._HDR.size + 2):
        corrupt = bytearray(data)
        corrupt[off] ^= 0xFF
        assert list(twal.iter_records(bytes(corrupt))) == []


def test_wal_reopen_truncates_torn_tail(tmp_path):
    log = twal.CommitLog(str(tmp_path))
    log.open_segment(0)
    log.append(twal.encode_record(twal.REC_PULL, (0, 0)))
    log.close()
    seg = tmp_path / "wal-000000000000.log"
    with open(seg, "ab") as f:
        f.write(b"\x01garbage-torn-tail")
    log2 = twal.CommitLog(str(tmp_path))
    log2.open_segment(0)
    log2.append(twal.encode_record(twal.REC_PULL, (1, 1)))
    log2.close()
    assert list(twal.iter_records(seg.read_bytes())) == [
        (twal.REC_PULL, (0, 0)), (twal.REC_PULL, (1, 1))]


def test_wal_snapshot_truncates_history(tmp_path):
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 2,
                             wal_dir=str(tmp_path), snapshot_every=4)
    for k in range(11):
        ps.pull(0)
        ps.commit(0, delta4(1.0), seq=k + 1)
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("snap-")] == [
        "snap-000000000008.dkw"]
    assert [n for n in names if n.startswith("wal-")] == [
        "wal-000000000008.log"]
    ps2 = tps.ParameterServer(center4(), tr.DownpourMerge(), 2,
                              wal_dir=str(tmp_path))
    assert ps2.recovered_ and ps2.num_updates == 11
    _tree_equal(ps2.get_model(), ps.get_model())


# -- recovery: the bit-identical oracle, within and across packages --------------


def _scripted(pkg: str, wal_dir, group_window: int, snapshot_every=7):
    """Scripted DynSGD events on a durable server of ``pkg``: irregular
    pulls, seq'd commits with replays, a fence, a fenced commit, a lease
    eviction (fake clock), a deregister; then a crash (the log abandoned).
    Returns the live state just before the crash."""
    ps_mod, res, rules = _PKG[pkg]
    ps = ps_mod.ParameterServer(center4(), rules.DynSGDMerge(), 3,
                                wal_dir=str(wal_dir),
                                snapshot_every=snapshot_every,
                                wal_group_window=group_window)
    clock = _Clock()
    _fake_lease(ps, res, 1.0, clock)
    rng = np.random.default_rng(0)
    for k in range(23):
        w = k % 3
        if k % 4 != 2:
            ps.pull(w)
        ps.commit(w, _randn(rng), seq=k + 1)
        if k % 5 == 4:
            assert ps.commit(w, _randn(rng), seq=k + 1) is False  # a replay
        if k == 9:
            ps.fence(1)
        if k == 12:
            with pytest.raises(Exception, match="fenced"):
                ps.commit(w, _randn(rng), seq=100, epoch=0)
        if k == 15:
            ps.heartbeat(2)
            clock.t = 5.0
            assert ps.stats()["evicted_workers"] == 1   # 2's lease lapsed
            assert 2 not in ps._pull_versions
    ps.deregister_worker(1)
    ex, _ = ps.exchange(0, _randn(rng), seq=200, lag=True)
    # the trailing records ride no commit's group fsync: stand in for the
    # flusher's time deadline, then crash
    ps._wal.sync()
    live = _live_state(ps)
    ps._wal.abandon()
    return live


@pytest.mark.parametrize("group_window", [1, 8])
@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_recovery_bit_identical_across_packages(writer, reader,
                                                group_window, tmp_path):
    """A log one package's server writes under scripted events (replays,
    a fence, a fenced commit, an eviction, a deregister, a lagged
    exchange) recovers, through the other package's server, to the live
    state bit for bit, and the next fold prices τ identically."""
    live = _scripted(writer, tmp_path, group_window)
    ps_mod, _res, rules = _PKG[reader]
    rec = ps_mod.ParameterServer(center4(), rules.DynSGDMerge(), 3,
                                 wal_dir=str(tmp_path))
    assert rec.recovered_
    _state_equal(_live_state(rec), live)
    assert live["fence_epoch"] == 1
    # the reader's replay, and the next fold on a second recovery
    state = (twal if reader == "port" else jwal).recover_ps_state(
        str(tmp_path), rules.DynSGDMerge(), 3, None, template=center4())
    _state_equal(state, live)
    rec.commit(2, delta4(0.25), seq=300)
    rec2 = ps_mod.ParameterServer(center4(), rules.DynSGDMerge(), 3,
                                  wal_dir=str(tmp_path))
    _tree_equal(rec2.get_model(), rec.get_model())
    rec.stop()
    rec2.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_tails_recover_alike_in_both_packages(writer, tmp_path):
    """A record torn mid-body, and a group whose fsync never came (the
    torn group), lose exactly the unACKed tail, the same in both
    packages' recovery; the torn commits' replays fold once."""
    ps_mod, _res, rules = _PKG[writer]
    d = tmp_path / "torn"
    ps = ps_mod.ParameterServer(center4(), rules.DownpourMerge(), 1,
                                wal_dir=str(d), wal_group_window=1)
    for k in range(3):
        ps.commit(0, delta4(1.0 + k), seq=k + 1)
    ps._wal.abandon()
    seg = next(p for p in os.listdir(d) if p.startswith("wal-"))
    path = os.path.join(str(d), seg)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 11)
    states = [m.recover_ps_state(str(d), rules.DownpourMerge(), 1, None,
                                 template=center4()) for m in (twal, jwal)]
    _state_equal(states[0], states[1])
    assert states[0]["num_updates"] == 2
    # the torn group: a huge window and interval pin the flusher, so the
    # last commits sit queued (unACKed in group mode) when the log dies
    g = tmp_path / "group"
    ps = ps_mod.ParameterServer(center4(), rules.DownpourMerge(), 1,
                                wal_dir=str(g), wal_group_window=64,
                                wal_group_interval=60.0)
    ps.commit(0, delta4(1.0), seq=1)     # its ACK waited for its fsync
    ps._wal.wait_durable = lambda token, timeout=0: True   # ACK, no fsync
    for k in range(1, 4):
        ps.commit(0, delta4(1.0 + k), seq=k + 1)
    ps._wal.abandon()
    states = [m.recover_ps_state(str(g), rules.DownpourMerge(), 1, None,
                                 template=center4()) for m in (twal, jwal)]
    _state_equal(states[0], states[1])
    assert states[0]["num_updates"] == 1
    rec = tps.ParameterServer(center4(), tr.DownpourMerge(), 1,
                              wal_dir=str(g))
    for k in range(4):                    # replay everything: dedup sorts
        rec.commit(0, delta4(1.0 + k), seq=k + 1)
    assert rec.num_updates == 4 and rec.stats()["dup_commits"] == 1
    np.testing.assert_array_equal(rec.get_model()["w"], 10.0)
    rec.stop()


def test_recovery_dedups_replay_of_pre_crash_commit(tmp_path):
    """Folded and logged before the crash, its ACK lost: the replay against
    the recovered server is refused as a duplicate."""
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 1,
                             wal_dir=str(tmp_path))
    ps.commit(0, delta4(1.0), seq=7)
    ps._wal.abandon()
    ps2 = tps.ParameterServer(center4(), tr.DownpourMerge(), 1,
                              wal_dir=str(tmp_path))
    assert ps2.commit(0, delta4(1.0), seq=7) is False
    assert ps2.commit(0, delta4(1.0), seq=8) is True
    np.testing.assert_array_equal(ps2.get_model()["w"], 2.0)
    ps2.stop()


def test_socket_ps_restart_in_place(tmp_path):
    """Commits over the wire, a crash, a fresh server on the same WAL: the
    state is identical and the wire answers again, refusing the
    pre-crash seq."""
    ps = _server(tps, center4(), tr.DownpourMerge(), 1,
                 wal_dir=str(tmp_path), snapshot_every=3)
    c = _client(tps, ps.port, 0)
    for k in range(5):
        c.pull()
        c.commit(0, delta4(1.0), seq=k + 1)
    before = ps.get_model()
    ps._crash()
    assert ps.crashed_
    with pytest.raises((ConnectionError, OSError)):
        c.commit(0, delta4(1.0), seq=6)
        c.commit(0, delta4(1.0), seq=7)
    ps2 = _server(tps, center4(), tr.DownpourMerge(), 1,
                  wal_dir=str(tmp_path), snapshot_every=3)
    try:
        assert ps2.recovered_ and ps2.wal_replay_s >= 0.0
        _tree_equal(ps2.get_model(), before)
        c2 = _client(tps, ps2.port, 0)
        c2.commit(0, delta4(1.0), seq=5)   # the pre-crash seq: refused
        c2.commit(0, delta4(1.0), seq=6)
        assert ps2.num_updates == 6
        c2.close()
    finally:
        ps2.stop()


def test_group_commit_acks_imply_fsync_and_batch(tmp_path):
    """Concurrent committers in group mode: every ACKed commit is fsync'd,
    so a crash right after loses none of them."""
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 4,
                             wal_dir=str(tmp_path), wal_group_window=8)
    errors = []

    def committer(w):
        try:
            for k in range(6):
                ps.pull(w)
                assert ps.commit(w, delta4(1.0), seq=k + 1) is True
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=committer, args=(w,))
               for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads)
    s = ps.stats()
    assert s["wal_records"] == 2 * 4 * 6
    assert s["wal_fsyncs"] >= 1 and s["wal_group_max"] >= 1
    before = ps.get_model()
    ps._wal.abandon()
    ps2 = tps.ParameterServer(center4(), tr.DownpourMerge(), 4,
                              wal_dir=str(tmp_path))
    assert ps2.num_updates == 24
    _tree_equal(ps2.get_model(), before)
    ps2.stop()


def test_torn_group_tail_replays_exactly_once(tmp_path):
    """The kill-PS seam fires between a commit's append and its group's
    fsync: the recovered server lacks it, the resilient client's replay
    through the repointed resolver folds it once, and the end state is
    the no-crash oracle's."""
    wal_dir = str(tmp_path / "wal")
    ps = _server(tps, center4(), tr.DownpourMerge(), 1, wal_dir=wal_dir,
                 wal_group_window=64, wal_group_interval=60.0)
    plan = tres.FaultPlan(kill_ps_after_commits=5)

    def kill_hook(version):
        if plan.should_kill_ps(version):
            plan.note_ps_kill()
            ps._crash()

    ps.post_commit_hook = kill_hook
    resolver = tres.PSEndpoint("127.0.0.1", ps.port, epoch=0)

    def mk():
        host, port, epoch = resolver.resolve()
        return tps.ParameterServerClient(host, port, 0, epoch=epoch,
                                         connect_timeout=5.0,
                                         timeout=TIMEOUT)

    rc = tres.ResilientPSClient(
        mk, 0, policy=tres.RetryPolicy(max_attempts=4, base_delay=0.01,
                                       max_delay=0.05, deadline=10),
        resolver=resolver)
    restarted = []
    try:
        for k in range(8):
            for _attempt in range(10):
                try:
                    rc.pull()
                    rc.commit(0, delta4(float(k + 1)))
                    break
                except (ConnectionError, OSError):
                    assert plan.stats()["ps_kills"] == 1
                    if not restarted:
                        new = _server(tps, center4(), tr.DownpourMerge(), 1,
                                      wal_dir=wal_dir, wal_group_window=64,
                                      wal_group_interval=60.0)
                        assert new.recovered_ and new.num_updates == 4
                        restarted.append(new)
                        resolver.update("127.0.0.1", new.port, 0)
            else:
                raise AssertionError(f"commit {k + 1} never landed")
        oracle = tps.ParameterServer(center4(), tr.DownpourMerge(), 1)
        for k in range(8):
            oracle.commit(0, delta4(float(k + 1)), seq=k + 1)
        new = restarted[0]
        assert new.num_updates == 8 == rc.seq
        _tree_equal(new.get_model(), oracle.get_model())
        rc.close()
    finally:
        for s in restarted:
            s.stop()
        ps.stop()


def test_wal_time_deadline_bounds_quiet_periods(tmp_path):
    """Pull records alone (no commit counter trips) are fsync'd within the
    group interval, in every mode."""
    for window in (1, 8, 0):
        ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 2,
                                 wal_dir=str(tmp_path / f"w{window}"),
                                 wal_group_window=window,
                                 wal_group_interval=0.05)
        for k in range(5):
            ps.pull(k % 2)
        deadline = time.monotonic() + TIMEOUT
        while True:
            with ps._wal._cond:
                if ps._wal._durable >= ps._wal._appended > 0:
                    break
            assert time.monotonic() < deadline, f"window={window}"
            time.sleep(0.01)
        assert ps._wal._appended == 5 and ps.stats()["wal_fsyncs"] >= 1
        ps.stop()


def test_wal_verify_matches_the_jax_package(tmp_path):
    """``verify_dir`` and the ``python -m distkeras_tpu_torch.resilience.wal
    verify`` CLI give the JAX package's verdict dict on the same
    directories: clean, a torn live tail (still ok), a flipped snapshot
    CRC (not ok)."""
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 2,
                             wal_dir=str(tmp_path), snapshot_every=4)
    for k in range(6):
        ps.pull(0)
        ps.commit(0, delta4(1.0), seq=k + 1)
    ps.deregister_worker(0)
    ps._wal.sync()
    ps._wal.abandon()
    rep = twal.verify_dir(str(tmp_path))
    assert rep == jwal.verify_dir(str(tmp_path)) and rep["ok"]
    assert rep["record_totals"] == {"commit": 2, "pull": 2, "dereg": 1}
    assert rep["snapshots"][0]["version"] == 4
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.resilience.wal",
         "verify", str(tmp_path)], capture_output=True, text=True,
        timeout=TIMEOUT, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and json.loads(out.stdout) == rep
    seg = sorted(p for p in os.listdir(tmp_path) if p.startswith("wal-"))[-1]
    with open(os.path.join(str(tmp_path), seg), "ab") as f:
        f.write(b"\x01torn-half-record")
    rep = twal.verify_dir(str(tmp_path))
    assert rep == jwal.verify_dir(str(tmp_path))
    assert rep["ok"] and rep["torn_tail_bytes"] > 0
    assert twal.main(["verify", str(tmp_path)]) == 0
    assert twal.main(["bogus"]) == 2
    snap = next(p for p in os.listdir(tmp_path) if p.startswith("snap-"))
    with open(os.path.join(str(tmp_path), snap), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    rep = twal.verify_dir(str(tmp_path))
    assert rep == jwal.verify_dir(str(tmp_path)) and not rep["ok"]
    assert twal.main(["verify", str(tmp_path)]) == 1


# -- fencing ----------------------------------------------------------------------


def test_fencing_inprocess_mismatch_is_fatal():
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 1, fence_epoch=2)
    ps.commit(0, delta4(1.0), seq=1, epoch=2)
    before = ps.stats()["bytes_in"]
    with pytest.raises(tnet.FencedEpochError) as ei:
        ps.commit(0, delta4(1.0), seq=2, epoch=1)
    assert (ei.value.server_epoch, ei.value.client_epoch) == (2, 1)
    assert not tres.is_retryable(ei.value)
    assert ps.num_updates == 1 and ps.stats()["fenced_commits"] == 1
    assert ps.stats()["bytes_in"] > before   # the payload crossed
    assert ps.commit(0, delta4(1.0), seq=3) is True   # epoch-less: folds


def test_failover_triage_refused_and_midhandshake_eof():
    """A refused connect and a mid-handshake EOF, the two faces of "the
    primary is being replaced", are retryable."""
    import socket as _socket

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(ConnectionError) as ei:
        tnet.connect("127.0.0.1", port, timeout=2)
    assert tres.is_retryable(ei.value)
    lst = _socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]

    def die_after_accept():
        conn, _ = lst.accept()
        conn.close()

    t = threading.Thread(target=die_after_accept, daemon=True)
    t.start()
    conn = tnet.connect("127.0.0.1", port, timeout=2)
    conn.settimeout(TIMEOUT)
    tnet.send_data(conn, {"action": "ping"})
    with pytest.raises((tnet.ProtocolError, ConnectionResetError)) as ei:
        tnet.recv_data(conn)
    assert tres.is_retryable(ei.value)
    conn.close()
    lst.close()
    t.join(timeout=TIMEOUT)


def test_resilient_client_rides_fence_through_resolver():
    """Fenced with a resolver that moved: reconnect, adopt the epoch, fold
    once. Without a resolver the fence is the end of the line."""
    ps = _server(tps, center4(), tr.DownpourMerge(), 1)
    try:
        resolver = tres.PSEndpoint("127.0.0.1", ps.port, epoch=0)

        def mk():
            host, port, epoch = resolver.resolve()
            return tps.ParameterServerClient(host, port, 0, epoch=epoch,
                                             timeout=TIMEOUT)

        rc = tres.ResilientPSClient(
            mk, 0, policy=tres.RetryPolicy(base_delay=0.001, max_delay=0.01,
                                           deadline=10), resolver=resolver)
        rc.commit(0, delta4(1.0))
        ps.fence(1)
        resolver.update("127.0.0.1", ps.port, 1)
        rc.commit(0, delta4(1.0))
        assert ps.num_updates == 2 and ps.stats()["fenced_commits"] == 1
        assert rc.retries >= 1
        rc.close()
        rc2 = tres.ResilientPSClient(
            mk, 0, policy=tres.RetryPolicy(base_delay=0.001, deadline=10))
        ps.fence(2)
        with pytest.raises(tnet.FencedEpochError):
            rc2.commit(0, delta4(1.0))
        rc2.close()
    finally:
        ps.stop()


# -- the hot standby ---------------------------------------------------------------


@pytest.mark.parametrize("primary,standby", [("port", "port"),
                                             ("jax", "port"),
                                             ("port", "jax")])
def test_standby_streams_and_promotes_bit_identical(primary, standby):
    """A standby applies the primary's stream and, promoted, holds its
    center, dedup table and pull versions bit for bit, across packages
    too; it refuses worker ops before promotion (retryable) and fences a
    stale-epoch client after; fencing the zombie primary refuses its late
    folds."""
    pmod, _pres, prules = _PKG[primary]
    smod, _sres, srules = _PKG[standby]
    ps = _server(pmod, center4(), prules.DynSGDMerge(), 2)
    sb = smod.StandbySocketParameterServer(center4(), srules.DynSGDMerge(),
                                           2)
    sb.initialize()
    sb.start()
    try:
        ps.attach_standby("127.0.0.1", sb.port)
        assert ps.has_standby
        c = _client(tps, ps.port, 0, epoch=0)
        early = _client(tps, sb.port, 1, epoch=0)
        with pytest.raises(tnet.ProtocolError) as ei:
            early.pull()
        assert ei.value.retryable
        early.close()
        rng = np.random.default_rng(1)
        for k in range(6):
            c.pull()
            c.commit(0, _randn(rng), seq=k + 1)
        c.commit(0, _randn(rng), seq=6)          # a replay: not streamed
        want = ps.get_model()
        sb.promote(epoch=1)                      # drains the stream itself
        assert sb.promoted_ and not sb.is_standby and sb.fence_epoch == 1
        assert sb.num_updates == 6
        _tree_equal(sb.get_model(), want)
        assert sb._last_seq == ps._last_seq
        assert sb._pull_versions == ps._pull_versions
        c2 = _client(tps, sb.port, 0, epoch=1)
        c2.commit(0, delta4(0.5), seq=7)
        assert sb.num_updates == 7
        stale = _client(tps, sb.port, 0, epoch=0)
        with pytest.raises(tnet.FencedEpochError):
            stale.commit(0, delta4(0.5), seq=8)
        stale.close()
        ps.fence(1)
        with pytest.raises(tnet.FencedEpochError):
            c.commit(0, delta4(0.5), seq=8)
        c.close()
        c2.close()
    finally:
        sb.stop()
        ps.stop()


# -- dedup bounds, the eviction race ---------------------------------------------


def test_dedup_table_bounded_across_worker_generations():
    """Deregister and eviction cycles retire dedup entries: the table
    never grows with worker generations."""
    ps = tps.ParameterServer(center4(), tr.DownpourMerge(), 4,
                             lease_timeout=1.0)
    clock = _Clock()
    _fake_lease(ps, tres, 1.0, clock)
    for gen in range(50):
        wid = gen % 7
        ps.heartbeat(wid)
        ps.commit(wid, delta4(0.0), seq=gen + 1)
        ps.deregister_worker(wid)
    assert ps._last_seq == {}
    for wid in range(7, 12):
        ps.heartbeat(wid)
        ps.commit(wid, delta4(0.0), seq=1)
    assert len(ps._last_seq) == 5
    clock.t = 10.0
    assert ps.stats()["evicted_workers"] == 5
    assert ps._last_seq == {} and ps.num_updates == 55


def test_kill_ps_chaos_requires_a_recovery_path():
    kw = dict(backend="ps", device="cpu",
              fault_plan=tres.FaultPlan(kill_ps_after_commits=5))
    with pytest.raises(ValueError, match="recovery path"):
        trainers.DOWNPOUR(_spec(), ps_transport="socket", **kw)
    with pytest.raises(ValueError, match="ps_transport='socket'"):
        trainers.DOWNPOUR(_spec(), ps_transport="inprocess", **kw)
    trainers.DOWNPOUR(_spec(), ps_transport="socket", ps_standby=True, **kw)


# -- the native server's C++ log -----------------------------------------------


@pytest.fixture(scope="module")
def tnative():
    from distkeras_tpu_torch import native, native_ps

    native.load_dkps()   # builds libdkps with g++; a failure fails the test
    return native_ps


def test_native_fencing_protocol_parity(tnative):
    """The C++ server through the port's client: FENCE raises the epoch,
    COMMIT_SEQ_E folds, refuses replays and fences like the Python PS, and
    an eviction retires the dedup entry."""
    center = {"w": np.zeros(5, np.float32)}
    ps = tnative.NativeSocketParameterServer(center, tr.DownpourMerge(), 2,
                                             lease_timeout=0.1)
    ps.initialize()
    ps.start()
    try:
        c = tnative.NativePSClient("127.0.0.1", ps.port, 0, ps.spec,
                                   epoch=0)
        c.set_timeout(TIMEOUT)
        d = {"w": np.ones(5, np.float32)}
        c.commit(0, d, seq=1)
        c.commit(0, d, seq=1)
        assert ps.fence(2) == 2 and ps.fence_epoch == 2
        with pytest.raises(tnet.FencedEpochError):
            c.commit(0, d, seq=2)
        with pytest.raises(tnet.FencedEpochError):
            c.exchange(0, d, seq=2)
        c.epoch = 2
        c.commit(0, d, seq=2)
        assert c.fence(3) == 3
        s = ps.stats()
        assert (s["commits"], s["dup_commits"], s["fenced_commits"],
                s["num_updates"]) == (2, 1, 2, 2)
        assert set(s) == set(tps.ParameterServer(
            center, tr.DownpourMerge(), 2).stats())
        c.epoch = None
        c.heartbeat()
        deadline = time.monotonic() + TIMEOUT
        while ps.stats()["evicted_workers"] == 0:
            assert time.monotonic() < deadline, "the lease never lapsed"
            time.sleep(0.02)
        c.commit(0, d, seq=1)       # the dedup entry went with the lease
        assert ps.num_updates == 3
        c.close()
    finally:
        ps.stop()


def test_native_log_replays_to_the_same_bits_in_both_packages(tnative,
                                                              tmp_path):
    """The port's native server writes the C++ WAL (flat records, group
    commit): both packages' ``recover_ps_state`` rebuild the live center,
    dedup seqnos and pull versions bit for bit, both ``verify_dir``s agree,
    and a restarted native server refuses the pre-crash seq."""
    center = {"w": np.arange(600, dtype=np.float32) * 1e-3,
              "b": {"x": np.ones(7, np.float32)}}
    ps = tnative.NativeSocketParameterServer(
        center, tr.DynSGDMerge(), 2, wal_dir=str(tmp_path),
        wal_group_window=4)
    ps.initialize()
    ps.start()
    clients = [tnative.NativePSClient("127.0.0.1", ps.port, i, ps.spec)
               for i in range(2)]
    rng = np.random.default_rng(3)
    try:
        for c in clients:
            c.set_timeout(TIMEOUT)
        for k in range(9):
            w = k % 2
            if k % 3 != 2:
                clients[w].pull()
            delta = {"w": rng.standard_normal(600).astype(np.float32),
                     "b": {"x": rng.standard_normal(7).astype(np.float32)}}
            clients[w].commit(w, delta, seq=k + 1)
        clients[0].commit(0, delta, seq=8)          # a replay: not logged
        clients[1].exchange(1, delta, seq=10, lag=True)
        live = ps.get_model()
        s = ps.stats()
        assert s["num_updates"] == 10 and s["dup_commits"] == 1
    finally:
        for c in clients:
            c.close()
        ps.stop()
    states = [m.recover_ps_state(str(tmp_path), r.DynSGDMerge(), 2, None,
                                 template=center)
              for m, r in ((twal, tr), (jwal, jr))]
    _state_equal(states[0], states[1])
    _tree_equal(states[0]["center"], live)
    assert states[0]["last_seq"] == {0: 9, 1: 10}
    rep = twal.verify_dir(str(tmp_path))
    assert rep == jwal.verify_dir(str(tmp_path))
    assert rep["ok"] and rep["record_totals"]["commit"] == 10
    ps2 = tnative.NativeSocketParameterServer(center, tr.DynSGDMerge(), 2,
                                              wal_dir=str(tmp_path))
    ps2.initialize()
    ps2.start()
    try:
        assert ps2.recovered_ and ps2.num_updates == 10
        _tree_equal(ps2.get_model(), live)
        c = tnative.NativePSClient("127.0.0.1", ps2.port, 0, ps2.spec)
        c.set_timeout(TIMEOUT)
        c.commit(0, delta, seq=9)
        assert ps2.num_updates == 10
        c.commit(0, delta, seq=11)
        assert ps2.num_updates == 11
        c.close()
    finally:
        ps2.stop()


def test_native_torn_group_lost_window_replays(tnative, tmp_path):
    """Window 0 (time-bounded async): commits ACK before their records
    leave the queue; ``crash()`` loses that window, and a client replaying
    every seq folds each once."""
    center = {"w": np.zeros(64, np.float32)}
    ps = tnative.NativeSocketParameterServer(
        center, tr.DownpourMerge(), 1, wal_dir=str(tmp_path),
        wal_group_window=0, wal_group_interval=120.0)
    ps.initialize()
    ps.start()
    c = tnative.NativePSClient("127.0.0.1", ps.port, 0, ps.spec)
    c.set_timeout(TIMEOUT)
    one = {"w": np.ones(64, np.float32)}
    for k in range(6):
        c.commit(0, one, seq=k + 1)
    ps.crash()
    assert ps.crashed_
    with pytest.raises(ConnectionError):
        c.commit(0, one, seq=7)
    c.close()
    ps2 = tnative.NativeSocketParameterServer(center, tr.DownpourMerge(), 1,
                                              wal_dir=str(tmp_path))
    ps2.initialize()
    ps2.start()
    try:
        lost = 6 - ps2.num_updates
        assert lost > 0
        c2 = tnative.NativePSClient("127.0.0.1", ps2.port, 0, ps2.spec)
        c2.set_timeout(TIMEOUT)
        for k in range(6):
            c2.commit(0, one, seq=k + 1)
        assert ps2.num_updates == 6
        np.testing.assert_array_equal(ps2.get_model()["w"], 6.0)
        assert ps2.stats()["dup_commits"] == 6 - lost
        c2.close()
    finally:
        ps2.stop()


# -- chaos: a PS killed mid-run ------------------------------------------------------


@pytest.mark.parametrize("cls_name,standby", [("ADAG", False),
                                              ("DOWNPOUR", True)],
                         ids=["restart", "standby"])
def test_ps_killed_mid_run_completes_and_converges(cls_name, standby,
                                                   tmp_path):
    """The primary crash-stopped mid-run under wire drops: one failover
    (restart in place from the WAL, or the standby promoted at epoch 1),
    lifetime folds equal the logical commits, the run learns below the
    clean run's first-epoch loss, and the active server's log replays to
    the final center bit for bit."""
    ds = Dataset.from_arrays(*blobs(n=1024))
    bar = _first_epoch_loss(cls_name, ds)
    wal_dir = str(tmp_path / "wal")
    plan = tres.FaultPlan(seed=13, drop_recv=0.02, delay=0.03, delay_s=0.002,
                          kill_ps_after_commits=8, max_faults=40)
    t = getattr(trainers, cls_name)(
        _spec(), **_KW, ps_transport="socket", ps_wal_dir=wal_dir,
        ps_snapshot_every=5, ps_standby=standby, ps_failover_timeout=2.0,
        retry_policy=tres.RetryPolicy(max_attempts=100, base_delay=0.005,
                                      max_delay=0.2, deadline=120),
        heartbeat_interval=0.05, fault_plan=plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the failover warning
        with plan:
            _watchdog(lambda: t.train(ds, shuffle=True))
    assert plan.stats()["ps_kills"] == 1
    fo = t.resilience_stats_["ps_failover"]
    assert fo["failovers"] >= 1
    assert fo["failover_log"][0]["via"] == ("standby" if standby
                                            else "restart")
    assert fo["failover_log"][0]["epoch"] == 1
    s = t.ps_stats_
    assert s["num_updates"] == t.resilience_stats_["logical_commits"] \
        == 4 * 16
    assert _final_loss(t) < bar
    od = os.path.join(wal_dir, "standby") if standby else wal_dir
    assert twal.verify_dir(od)["ok"]
    state = twal.recover_ps_state(od, t.allocate_merge_rule(), 4, None)
    assert state["num_updates"] == s["num_updates"]
    _tree_equal(state["center"], {k: v.numpy() for k, v in
                                  t.trained_params_.items()})
    assert {r["worker"] for r in t.history.records if "loss" in r} == \
        {0, 1, 2, 3}
