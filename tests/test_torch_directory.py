"""The port's membership directory (``distkeras_tpu_torch/directory/``, the
``publish=`` path of the failover supervisor, the directory re-resolve of
the resilient client, the shm rendezvous, ``register_with`` and the
trainer's ``directory`` / ``ps_directory`` knobs) held against the JAX
package's on the CPU.

The oracles are the reference's own (``tests/test_directory.py``, one for
one, and ``tests/test_frontdoor.py``'s ring weights): WAL replay of the
directory is bit-identical to the live state; leases expire on an injected
clock (no wall-clock races); registration races resolve to the higher
fence epoch in either order; a promotion is published before the old
primary is fenced, and a zombie's old-epoch commit is fenced; a client is
built from a lookup alone; the chaos run (a PS shard and the directory
primary killed, a joiner minted from the directory) is exactly once a
shard with the center bit-identical to each shard's log replay; the
router survives a killed replica with every stream complete.

Across packages, tolerance 0 everywhere: a directory log either package
writes recovers under the other's ``recover_directory_state`` to the same
state; each package's ``DirectoryClient`` works against the other's
``DirectoryServer``; the same ``FaultPlan`` makes the same directory drop
and kill decisions; the router's greedy streams over two f32 replicas
equal the JAX package's dense ``generate`` token for token, and the JAX
package's router sends each prefix to the same replica.

Every test stops every server, standby, supervisor, renewer and client it
starts; training runs run under a watchdog.
"""

import json
import os
import socket as _socket
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import directory as jdir
from distkeras_tpu.resilience import faults as jfaults
from distkeras_tpu_torch import networking
from distkeras_tpu_torch import shm as tshm
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.directory import (
    DirectoryClient,
    DirectoryEndpoint,
    DirectoryServer,
    HostedDirectory,
    RoutedGenerationClient,
    StandbyDirectoryServer,
    build_ps_client,
    install_shm_rendezvous,
    parse_seeds,
    prefix_route_key,
    recover_directory_state,
)
from distkeras_tpu_torch.directory.router import _ReplicaRing
from distkeras_tpu_torch.networking import (
    FencedEpochError,
    ShardMapMismatchError,
)
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parameter_servers import (
    ParameterServer,
    ParameterServerClient,
    SocketParameterServer,
    StandbySocketParameterServer,
)
from distkeras_tpu_torch.resilience import FaultPlan, RetryPolicy
from distkeras_tpu_torch.resilience import wal as walmod
from distkeras_tpu_torch.resilience.recovery import PSFailoverSupervisor
from distkeras_tpu_torch.resilience.retry import PSEndpoint, ResilientPSClient
from tests.test_torch_ps import _final_loss, _spec, blobs
from tests.test_torch_resilience import _watchdog


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _start(srv):
    srv.initialize()
    srv.start()
    return srv


def _wait(pred, limit=5.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)
    return pred()


_KW = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
           backend="ps", device="cpu")


# -- seeds & the map ----------------------------------------------------------


def test_parse_seeds_shapes():
    assert parse_seeds("h:9") == [("h", 9)]
    assert parse_seeds([("a", 1), "b:2"]) == [("a", 1), ("b", 2)]
    assert parse_seeds(("a", 1)) == [("a", 1)]
    with pytest.raises(ValueError, match="host:port"):
        parse_seeds(["nope"])
    with pytest.raises(ValueError, match="at least one"):
        parse_seeds([])
    for seeds in ("h:9", [("a", 1), "b:2"], ("a", 1)):
        assert parse_seeds(seeds) == jdir.parse_seeds(seeds)


def test_publish_lookup_withdraw_roundtrip():
    srv = _start(DirectoryServer(default_ttl=None))
    c = DirectoryClient([(srv.host, srv.port)])
    try:
        assert c.publish("ps", "shard-00", "10.0.0.1", 7000,
                         meta={"num_shards": 1})["ok"]
        es = c.lookup("ps")
        assert [(e["key"], e["host"], e["port"]) for e in es] \
            == [("shard-00", "10.0.0.1", 7000)]
        assert c.lookup("serve") == []
        assert c.withdraw("ps", "shard-00")["ok"]
        assert c.lookup("ps") == []
        # withdrawing an absent entry is idempotent
        assert c.withdraw("ps", "shard-00")["ok"]
    finally:
        c.close()
        srv.stop()


def test_lease_expiry_under_stalled_heartbeat():
    """On an injected clock: of two entries one renews and one stalls;
    only the stalled one expires, the expiry is a durable record, and a
    lookup never serves a lapsed lease."""
    clock = FakeClock()
    srv = DirectoryServer(default_ttl=2.0, clock=clock)
    srv.publish("ps", "live", "h", 1)
    srv.publish("ps", "stalled", "h", 2)
    for _ in range(4):
        clock.advance(1.0)
        srv.renew("ps", "live")
    assert {e["key"] for e in srv.lookup("ps")} == {"live"}
    assert srv.expired_entries == 1
    assert srv.stats()["entries"] == 1
    state = srv.state.snapshot()
    assert ("ps", "stalled") not in state["entries"]
    # the promoted owner's re-registration re-admits it
    srv.publish("ps", "stalled", "h2", 3, epoch=1)
    assert {e["key"] for e in srv.lookup("ps")} == {"live", "stalled"}
    srv.stop()


def test_registration_race_higher_fence_epoch_wins_both_orders():
    srv = _start(DirectoryServer(default_ttl=None))
    c = DirectoryClient([(srv.host, srv.port)])
    try:
        # high then low: the stale promotion is rejected
        assert c.publish("ps", "shard-00", "new", 2, epoch=5)["ok"]
        r = c.publish("ps", "shard-00", "old", 1, epoch=3)
        assert not r["ok"] and r["error"] == "stale_epoch" \
            and r["epoch"] == 5
        assert c.lookup("ps", "shard-00")[0]["host"] == "new"
        # low then high: the higher epoch replaces
        assert c.publish("ps", "shard-01", "old", 1, epoch=3)["ok"]
        assert c.publish("ps", "shard-01", "new", 2, epoch=5)["ok"]
        assert c.lookup("ps", "shard-01")[0]["host"] == "new"
        # a stale withdraw cannot erase the promoted entry either
        assert not c.withdraw("ps", "shard-01", epoch=3)["ok"]
        assert c.lookup("ps", "shard-01")[0]["host"] == "new"
        assert srv.stale_rejects == 2
    finally:
        c.close()
        srv.stop()


# -- durability -----------------------------------------------------------------


def _mixed_history(srv):
    srv.publish("ps", "shard-00", "h", 1)
    srv.publish("ps", "shard-01", "h", 2)
    srv.publish("serve", "r1", "h", 3)
    srv.publish("ps", "shard-00", "h2", 4, epoch=1)   # a failover repoint
    srv.withdraw("serve", "r1")
    srv.fence(2)


def test_directory_wal_replay_bit_identity(tmp_path):
    """A crash (no tidy close) after a mixed history: the recovered state,
    across a snapshot mid-history, equals the live state exactly; ``wal
    verify`` reports the root healthy and flags it as a directory log; a
    restart in place adopts the state and serves it."""
    d = str(tmp_path)
    srv = _start(DirectoryServer(wal_dir=d, default_ttl=None,
                                 snapshot_every=3))
    _mixed_history(srv)
    live = srv.state.snapshot()
    srv._crash()
    srv.stop()
    rec = recover_directory_state(d)
    assert rec is not None and rec.snapshot() == live
    report = walmod.verify_tree(d)
    assert report["ok"], report
    assert report["directory"] is True
    assert report["record_totals"].get("dir_fence") == 1
    srv2 = _start(DirectoryServer(wal_dir=d, default_ttl=None))
    c = DirectoryClient([(srv2.host, srv2.port)])
    try:
        assert srv2.recovered_ and srv2.state.snapshot() == live
        assert {e["key"] for e in c.lookup("ps")} \
            == {"shard-00", "shard-01"}
    finally:
        c.close()
        srv2.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_directory_log_recovers_in_the_other_package(writer, tmp_path):
    """The same history logged by one package's ``DirectoryServer``
    (snapshot every 3 records, then a crash) recovers under the other
    package's ``recover_directory_state`` to the writer's live state, and
    both packages' recoveries agree (tolerance 0)."""
    d = str(tmp_path)
    mod = jdir if writer == "jax" else None
    cls = mod.DirectoryServer if mod is not None else DirectoryServer
    srv = cls(wal_dir=d, default_ttl=None, snapshot_every=3)
    _mixed_history(srv)
    srv.publish("shm", "seg", "h", 0, meta={"bytes": 4096}, ttl=2.5)
    live = srv.state.snapshot()
    srv._crash()
    srv.stop()
    mine = recover_directory_state(d)
    theirs = jdir.recover_directory_state(d)
    assert mine.snapshot() == theirs.snapshot() == live
    assert mine.replayed == theirs.replayed
    # and a server of the other package restarts in place on that log
    other = DirectoryServer if writer == "jax" else jdir.DirectoryServer
    again = other(wal_dir=d, default_ttl=None)
    assert again.recovered_ and again.state.snapshot() == live
    again.stop()


def test_wal_verify_walks_shared_root_with_directory(tmp_path):
    """A training root holding a shard's commit log and the directory's
    log under ``directory/`` verifies as one report that counts the
    directory dirs; a torn directory tail on a non-live segment fails
    it."""
    root = str(tmp_path)
    ps = ParameterServer({"w": np.zeros(8, np.float32)}, tr.DownpourMerge(),
                         1, wal_dir=os.path.join(root, "shard-00"),
                         wal_group_window=1)
    ps.pull(0)
    ps.commit(0, {"w": np.ones(8, np.float32)}, seq=1)
    ps.stop()
    dsrv = DirectoryServer(wal_dir=os.path.join(root, "directory"),
                           default_ttl=None)
    dsrv.publish("ps", "shard-00", "h", 1)
    dsrv.stop()
    rep = walmod.verify_tree(root)
    assert rep["ok"] and rep.get("sharded")
    assert rep["num_directory_dirs"] == 1
    by_dir = {r["dir"]: r for r in rep["dirs"]}
    assert by_dir["directory"]["directory"] is True
    assert by_dir["shard-00"]["directory"] is False
    ddir = os.path.join(root, "directory")
    seg = sorted(n for n in os.listdir(ddir) if n.startswith("wal-"))[0]
    with open(os.path.join(ddir, seg), "r+b") as f:
        f.seek(0, 2)
        f.truncate(max(f.tell() - 3, 1))
    with open(os.path.join(ddir, "wal-999999999999.log"), "wb") as f:
        f.write(b"")   # a later (live) segment: the torn one is not live
    assert not walmod.verify_tree(root)["ok"]


def test_ttl_only_republish_is_durable(tmp_path):
    """A re-publish that changes only the lease's ttl is a logged record:
    recovery re-arms leases from the stored ttl."""
    d = str(tmp_path)
    srv = DirectoryServer(wal_dir=d, default_ttl=None)
    srv.publish("ps", "shard-00", "h", 1, ttl=None)
    srv.publish("ps", "shard-00", "h", 1, ttl=2.0)
    live = srv.state.snapshot()
    assert live["entries"][("ps", "shard-00")]["ttl"] == 2.0
    srv._crash()
    srv.stop()
    assert recover_directory_state(d).snapshot() == live


def test_snapshot_loader_takes_tuple_keys_and_refuses_globals(tmp_path):
    """The directory's snapshot keys are tuples of strings: the restricted
    loader reads them and still refuses any global."""
    import pickle
    import struct
    import zlib

    d = str(tmp_path)
    srv = DirectoryServer(wal_dir=d, default_ttl=None, snapshot_every=1)
    srv.publish("ps", "shard-00", "h", 1)
    srv.stop()
    snaps = [n for n in os.listdir(d) if n.startswith("snap-")]
    assert snaps
    blob = walmod._load_snapshot(os.path.join(d, snaps[0]))
    assert ("ps", "shard-00") in blob["entries"]
    evil = pickle.dumps({"num_updates": 1, "entries": {("a", "b"): print},
                         "fence_epoch": 0})
    bad = os.path.join(d, "snap-999999999999.dkw")
    with open(bad, "wb") as f:
        f.write(struct.pack(">I", zlib.crc32(evil)) + evil)
    assert walmod._load_snapshot(bad) is None


def test_directory_restart_in_place_keeps_seed_address(tmp_path):
    """No standby, a WAL: the supervisor's restart in place rebinds the
    original primary port, the seed every client holds."""
    hosted = HostedDirectory(wal_dir=str(tmp_path), standby=False,
                             failover_timeout=0.3)
    hosted.start()
    c = None
    try:
        seeds = hosted.seeds
        c = DirectoryClient(seeds)
        c.publish("ps", "shard-00", "h", 7, ttl=None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the failover notice
            hosted.primary._crash()
            deadline = time.monotonic() + 15.0
            entries = []
            while time.monotonic() < deadline:
                try:
                    entries = c.lookup("ps", "shard-00")
                    if entries:
                        break
                except ConnectionError:
                    pass
                time.sleep(0.1)
        assert entries and entries[0]["port"] == 7
        assert hosted.supervisor.failovers == 1
        assert hosted.active.port == seeds[0][1]
    finally:
        if c is not None:
            c.close()
        hosted.stop()


# -- replication & promotion ----------------------------------------------------


def test_chain_replication_apply_and_forward_and_promotion():
    """primary → s1 → s2: every record applies on both links; promoting s1
    stamps the bumped epoch and keeps forwarding its writes to s2; a
    client over the seeds lands on the promoted primary."""
    srv = _start(DirectoryServer(default_ttl=None))
    s1 = _start(StandbyDirectoryServer(default_ttl=None))
    s2 = _start(StandbyDirectoryServer(default_ttl=None))
    c = None
    try:
        s1.attach_standby(s2.host, s2.port)   # tail first
        srv.attach_standby(s1.host, s1.port)
        srv.publish("ps", "shard-00", "h", 1)
        srv.publish("serve", "r", "h", 2)
        assert _wait(lambda: len(s1.state.entries) == 2
                     and len(s2.state.entries) == 2)
        assert s1.state.snapshot() == srv.state.snapshot()
        assert s2.state.snapshot() == srv.state.snapshot()
        srv._crash()
        s1.promote(epoch=3)
        assert s1.fence_epoch == 3 and not s1.is_standby and s1.promoted_
        s1.publish("ps", "shard-00", "h9", 9, epoch=3)
        assert _wait(lambda: s2.state.entries.get(
            ("ps", "shard-00"), {}).get("port") == 9)
        assert s2.state.fence_epoch == 3   # the fence rode the chain too
        c = DirectoryClient([(srv.host, srv.port), (s1.host, s1.port)])
        assert c.lookup("ps", "shard-00")[0]["port"] == 9
    finally:
        if c is not None:
            c.close()
        for s in (srv, s1, s2):
            s.stop()


def test_standby_wal_rebased_on_stream_adoption(tmp_path):
    """A durable standby whose own log holds an older history adopts a
    newer primary's base: its log is re-based, so streamed records append
    without a version gap and a later recovery replays cleanly."""
    stb_dir = str(tmp_path)
    old = DirectoryServer(wal_dir=stb_dir, default_ttl=None)
    old.publish("ps", "stale", "h", 1)
    old.stop()
    primary = _start(DirectoryServer(default_ttl=None))
    for i in range(3):
        primary.publish("ps", f"shard-{i:02d}", "h", 10 + i)
    stb = _start(StandbyDirectoryServer(wal_dir=stb_dir, default_ttl=None))
    try:
        assert stb.recovered_ and stb.state.version == 1
        primary.attach_standby(stb.host, stb.port)
        primary.publish("ps", "shard-03", "h", 13)
        assert _wait(lambda: stb.state.version >= 4)
        assert stb.state.snapshot() == primary.state.snapshot()
        stb._crash()
        rec = recover_directory_state(stb_dir)
        assert rec is not None
        assert rec.snapshot() == primary.state.snapshot()
    finally:
        primary.stop()
        stb.stop()


def test_client_prefers_highest_epoch_never_a_zombie():
    """A promoted replica at epoch 2 and a zombie old primary at epoch 0:
    the seed probe picks the higher fence epoch in either seed order."""
    zombie = _start(DirectoryServer(default_ttl=None))
    zombie.publish("ps", "shard-00", "stale", 1)
    promoted = _start(DirectoryServer(default_ttl=None, fence_epoch=2))
    promoted.publish("ps", "shard-00", "fresh", 2, epoch=2)
    try:
        for seeds in ([(zombie.host, zombie.port),
                       (promoted.host, promoted.port)],
                      [(promoted.host, promoted.port),
                       (zombie.host, zombie.port)]):
            c = DirectoryClient(seeds)
            try:
                assert c.lookup("ps", "shard-00")[0]["host"] == "fresh"
            finally:
                c.close()
    finally:
        zombie.stop()
        promoted.stop()


# -- across packages --------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_client_jax_server",
                                       "jax_client_port_server"])
def test_client_server_interop_with_the_jax_package(direction):
    """Each package's ``DirectoryClient`` against the other's
    ``DirectoryServer``: publish, lookup, the stale-epoch refusal,
    withdraw, membership and stats answer as the same-package pair does,
    and a ``DirectoryEndpoint`` resolves through it."""
    port_client = direction == "port_client_jax_server"
    server_cls = jdir.DirectoryServer if port_client else DirectoryServer
    client_cls = DirectoryClient if port_client else jdir.DirectoryClient
    endpoint_cls = DirectoryEndpoint if port_client \
        else jdir.DirectoryEndpoint
    srv = _start(server_cls(default_ttl=None))
    c = client_cls([(srv.host, srv.port)])
    try:
        assert c.publish("ps", "shard-00", "10.0.0.1", 7000, epoch=1,
                         meta={"num_shards": 2, "ring": "ab"})["ok"]
        assert c.publish("ps", "shard-01", "10.0.0.2", 7001,
                         meta={"num_shards": 2})["ok"]
        r = c.publish("ps", "shard-00", "old", 1, epoch=0)
        assert (r["ok"], r["error"], r["epoch"]) == (False, "stale_epoch", 1)
        got = c.lookup("ps")
        assert [(e["key"], e["host"], e["port"], e["epoch"], e["meta"])
                for e in got] == [
            ("shard-00", "10.0.0.1", 7000, 1, {"num_shards": 2,
                                                "ring": "ab"}),
            ("shard-01", "10.0.0.2", 7001, 0, {"num_shards": 2})]
        ep = endpoint_cls(c, "ps", "shard-00")
        assert ep.resolve() == ("10.0.0.1", 7000, 1)
        assert c.withdraw("ps", "shard-01")["ok"]
        m = c.membership()
        assert [e["key"] for e in m["entries"]] == ["shard-00"]
        assert m["version"] == 3 and not m["standby"]
        s = c.stats()
        assert (s["publishes"], s["stale_rejects"], s["withdraws"]) \
            == (2, 1, 1)
    finally:
        c.close()
        srv.stop()


def test_fault_plan_directory_decisions_equal_the_jax_package():
    """The same schedule makes the same drop and kill decisions, op for
    op, and counts them the same, in both packages; a live server of each
    package under its plan tears the same ops."""
    kw = dict(seed=0, kill_directory_after_ops=25,
              directory_partition_after=5, directory_partition_ops=7)
    mine, theirs = FaultPlan(**kw), jfaults.FaultPlan(**kw)
    got = [mine.take_directory_op() for _ in range(40)]
    ref = [theirs.take_directory_op() for _ in range(40)]
    assert got == ref
    assert got.count("drop") == 7 and got.count("kill") == 1
    keys = ("directory_ops", "directory_drops", "directory_kills")
    assert {k: mine.stats()[k] for k in keys} \
        == {k: theirs.stats()[k] for k in keys}

    def torn(server_cls, plan_cls):
        plan = plan_cls(seed=0, directory_partition_after=2,
                        directory_partition_ops=3)
        srv = _start(server_cls(default_ttl=None, fault_plan=plan))
        out = []
        try:
            for i in range(8):
                s = _socket.create_connection((srv.host, srv.port),
                                              timeout=5)
                try:
                    networking.send_data(s, {"action": "lookup",
                                             "role": "ps"})
                    try:
                        out.append(networking.recv_data(s)["ok"])
                    except (ConnectionError, EOFError, OSError):
                        out.append("torn")
                finally:
                    s.close()
        finally:
            srv.stop()
        return out, plan.stats()["directory_drops"]

    assert torn(DirectoryServer, FaultPlan) \
        == torn(jdir.DirectoryServer, jfaults.FaultPlan) \
        == ([True, True, "torn", "torn", "torn", True, True, True], 3)


# -- publish-then-fence ------------------------------------------------------------


def test_failover_publish_then_fence_ordering():
    """The failover runs promote, then the resolver and the directory
    publication (both carrying the bumped epoch), then the fence: at fence
    time the resolver already names the new primary at the new epoch and
    the directory entry is written."""
    events = []

    class FakeStandby:
        host, port = "newhost", 4242
        promoted_ = False
        crashed_ = False
        _running = True

        def promote(self, epoch):
            events.append(("promote", epoch))
            self.promoted_ = True

    resolver = PSEndpoint("oldhost", 1111, epoch=0)
    published = []

    def publish(host, port, epoch):
        assert resolver.resolve() == (host, port, epoch)
        published.append((host, port, epoch))
        events.append(("publish", epoch))

    sup = PSFailoverSupervisor(resolver, primary=object(),
                               standby=FakeStandby(), publish=publish)

    def fence(host, port, epoch):
        events.append(("fence", epoch))
        assert resolver.resolve() == ("newhost", 4242, 1)
        assert published == [("newhost", 4242, 1)]
        assert (host, port) == ("oldhost", 1111)
        return True

    sup._try_fence = fence
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the failover notice itself
        sup._failover_impl()
    assert [e[0] for e in events] == ["promote", "publish", "fence"]
    assert sup.failover_log[0]["fence_confirmed"] is True
    assert sup.failover_log[0]["published"] is True
    assert sup.publishes == 1


def test_failed_publication_is_kept_and_sent_later():
    """A publication the directory could not take (it is failing over) is
    kept and sent on a later watch tick; the fence is not held back."""
    calls = []

    class FakeStandby:
        host, port = "newhost", 4242
        promoted_ = crashed_ = False
        _running = True

        def promote(self, epoch):
            self.promoted_ = True

    def publish(host, port, epoch):
        calls.append((host, port, epoch))
        if len(calls) == 1:
            raise ConnectionRefusedError("directory failing over")

    sup = PSFailoverSupervisor(PSEndpoint("oldhost", 1111), object(),
                               standby=FakeStandby(), publish=publish)
    sup._try_fence = lambda *a: True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sup._failover_impl()
    assert sup.failover_log[0]["published"] is False
    assert sup._pending_publish == ("newhost", 4242, 1)
    assert sup._publish_now(*sup._pending_publish)
    assert sup._pending_publish is None and sup.publishes == 1
    assert calls == [("newhost", 4242, 1)] * 2


def test_zombie_primary_fenced_after_promotion_published():
    """Against a live (stalled, not dead) old primary: after the failover
    a slow worker's old-epoch commit to it is fenced while the promoted
    primary serves the new epoch."""
    tree = {"w": np.zeros(16, np.float32)}
    old = _start(SocketParameterServer(dict(tree), tr.DownpourMerge(), 2))
    stb = _start(StandbySocketParameterServer(dict(tree),
                                              tr.DownpourMerge(), 2))
    old.attach_standby("127.0.0.1", stb.port)
    resolver = PSEndpoint("127.0.0.1", old.port, epoch=0)
    sup = PSFailoverSupervisor(resolver, old, standby=stb)
    fast = slow = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sup._failover_impl()
        assert resolver.resolve() == ("127.0.0.1", stb.port, 1)
        fast = ParameterServerClient("127.0.0.1", stb.port, 0, epoch=1)
        fast.pull()
        fast.commit(0, {"w": np.ones(16, np.float32)}, seq=1)
        slow = ParameterServerClient("127.0.0.1", old.port, 1, epoch=0)
        with pytest.raises(FencedEpochError):
            slow.commit(1, {"w": np.ones(16, np.float32)}, seq=1)
        assert old.num_updates == 0 and stb.num_updates == 1
        assert sup.failover_log[0]["fence_confirmed"] is True
    finally:
        for c in (fast, slow):
            if c is not None:
                c.close()
        sup.stop()
        old.stop()
        stb.stop()


# -- directory-backed resolution ----------------------------------------------------


def test_resilient_client_re_resolves_through_directory():
    """A ``ResilientPSClient`` over a ``DirectoryEndpoint``: the primary
    dies, a replacement registers at a bumped epoch, and the next op
    reconnects through a directory refresh."""
    tree = {"w": np.zeros(16, np.float32)}
    dsrv = _start(DirectoryServer(default_ttl=None))
    a = _start(SocketParameterServer(dict(tree), tr.DownpourMerge(), 1))
    dc = DirectoryClient([(dsrv.host, dsrv.port)])
    dc.publish("ps", "shard-00", "127.0.0.1", a.port, epoch=0)
    resolver = DirectoryEndpoint(dc, "ps", "shard-00")

    def mk():
        host, port, epoch = resolver.resolve()
        return ParameterServerClient(host, port, 0, epoch=epoch,
                                     timeout=30.0)

    client = ResilientPSClient(
        mk, 0, policy=RetryPolicy(max_attempts=60, base_delay=0.01,
                                  max_delay=0.1, deadline=30.0),
        resolver=resolver)
    b = None
    try:
        client.pull()
        client.commit(0, {"w": np.ones(16, np.float32)})
        a._crash()
        b = _start(SocketParameterServer(dict(tree), tr.DownpourMerge(), 1,
                                         fence_epoch=1))
        dc.publish("ps", "shard-00", "127.0.0.1", b.port, epoch=1)
        client.pull()                      # reconnect → refresh → b
        client.commit(0, {"w": np.ones(16, np.float32)})
        assert b.num_updates == 1
        assert resolver.refreshes >= 1
        assert resolver.resolve() == ("127.0.0.1", b.port, 1)
    finally:
        client.close()
        dc.close()
        if b is not None:
            b.stop()
        a.stop()
        dsrv.stop()


def test_build_ps_client_from_directory_alone():
    """A 2-shard fleet registered in the directory; a worker's client is
    minted from the seeds and the local template only, passes the
    shard-map handshake and folds exactly once (tolerance 0 against the
    center plus the delta); a different ring digest fails fast."""
    from distkeras_tpu_torch.sharding import ShardedPSGroup

    rng = np.random.default_rng(0)
    tree = {"emb": rng.normal(size=(64,)).astype(np.float32),
            "w": rng.normal(size=(24,)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}
    group = ShardedPSGroup(tree, tr.DownpourMerge(), 1, num_shards=2,
                           transport="socket")
    group.initialize()
    group.start()
    dsrv = _start(DirectoryServer(default_ttl=None))
    dc = DirectoryClient([(dsrv.host, dsrv.port)])
    try:
        meta = {"num_shards": 2, "ring": group.plan.digest,
                "vnodes": group.plan.ring.vnodes, "bound": group.plan.bound}
        for sid, srv in enumerate(group.servers):
            dc.publish("ps", f"shard-{sid:02d}", srv.host, srv.port,
                       epoch=0, meta=meta)
        client = build_ps_client([(dsrv.host, dsrv.port)], tree,
                                 worker_id=0)
        base = client.pull()
        delta = {k: np.full_like(v, 0.5) for k, v in base.items()}
        client.commit(0, delta)
        got = client.pull()
        for k in tree:
            np.testing.assert_array_equal(got[k], base[k] + np.float32(0.5))
        s = group.stats()
        assert s["num_updates"] == s["num_updates_max"] == 1
        client.close()
        dc.publish("ps", "shard-00", group.servers[0].host,
                   group.servers[0].port, epoch=1,
                   meta={**meta, "ring": "0" * 40})
        with pytest.raises(ShardMapMismatchError, match="different plan"):
            build_ps_client([(dsrv.host, dsrv.port)], tree, worker_id=1)
    finally:
        dc.close()
        dsrv.stop()
        group.stop()


def test_directory_partition_window_is_retried_through():
    """A directory partition (an op-count window) tears lookups; the
    client's retry rides it out and the drops are counted."""
    plan = FaultPlan(seed=0, directory_partition_after=2,
                     directory_partition_ops=3)
    srv = _start(DirectoryServer(default_ttl=None, fault_plan=plan))
    c = DirectoryClient([(srv.host, srv.port)])
    try:
        c.publish("ps", "shard-00", "h", 1)          # op 1
        c.publish("ps", "shard-01", "h", 2)          # op 2
        for _ in range(4):                           # ops 3.. partitioned
            assert len(c.lookup("ps")) == 2
        assert plan.stats()["directory_drops"] == 3
    finally:
        c.close()
        srv.stop()


# -- trainer integration ------------------------------------------------------------


def test_trainer_directory_run_and_stats():
    """``directory=True`` on the socket transport: the run trains through
    directory-minted clients, the registrations and the final membership
    land in ``directory_stats_`` and ``resilience_stats_``, JSON-clean."""
    ds = Dataset.from_arrays(*blobs(n=256))
    t = trainers.ADAG(_spec(), learning_rate=0.1, num_workers=1,
                      batch_size=32, communication_window=2, num_epoch=1,
                      ps_transport="socket", directory=True,
                      ps_num_shards=2, **_KW)
    _watchdog(lambda: t.train(ds, shuffle=False))
    dstats = t.directory_stats_
    assert [tuple(k) for k in dstats["registered"]] \
        == [("ps", "shard-00"), ("ps", "shard-01")]
    keys = {e["key"] for e in dstats["membership"]["entries"]}
    assert keys == {"shard-00", "shard-01"}
    assert dstats["primary"]["lookups"] >= 1   # the client was minted here
    assert dstats["failover"]["failovers"] == 0
    assert t.resilience_stats_["directory"] == dstats
    assert t.ps_stats_["num_updates"] == \
        t.resilience_stats_["logical_commits"] > 0
    json.dumps(dstats)
    json.dumps(t.resilience_stats_)


def test_trainer_directory_single_ps_registers_shard_zero_of_one():
    """One socket PS under ``directory=True``: registered as shard 0 of 1,
    non-expiring (no supervisor renews it), and the worker's client is
    minted from it."""
    ds = Dataset.from_arrays(*blobs(n=256))
    t = trainers.DOWNPOUR(_spec(), learning_rate=0.02, num_workers=2,
                          batch_size=32, communication_window=2,
                          num_epoch=1, ps_transport="socket",
                          directory=True, directory_standby=False, **_KW)
    _watchdog(lambda: t.train(ds, shuffle=False))
    entries = t.directory_stats_["membership"]["entries"]
    assert [(e["key"], e["meta"], e["ttl"]) for e in entries] \
        == [("shard-00", {"num_shards": 1}, None)]
    assert t.directory_stats_["primary"]["lookups"] >= 2
    assert "failover" not in t.directory_stats_   # no standby, no WAL


def test_trainer_validates_directory_knobs():
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              num_workers=1, backend="ps", device="cpu")
    with pytest.raises(ValueError, match="socket"):
        trainers.ADAG(_spec(), directory=True, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        trainers.ADAG(_spec(), ps_transport="socket", directory=True,
                      ps_directory="h:1", **kw)
    with pytest.raises(ValueError, match="ps_host"):
        trainers.ADAG(_spec(), ps_transport="socket", directory=True,
                      ps_host="10.0.0.1", **kw)
    with pytest.raises(ValueError, match="owner"):
        trainers.ADAG(_spec(), ps_transport="socket", ps_directory="h:1",
                      ps_num_shards=2, **kw)
    with pytest.raises(ValueError, match="ps_transport='socket'"):
        trainers.ADAG(_spec(), ps_transport="native", ps_directory="h:1",
                      **kw)
    with pytest.raises(ValueError, match="backend='ps'"):
        trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", num_workers=1, directory=True,
                      device="cpu")
    # directory chaos without a directory would silently test nothing
    with pytest.raises(ValueError, match="directory"):
        trainers.ADAG(_spec(), ps_transport="socket",
                      fault_plan=FaultPlan(kill_directory_after_ops=5), **kw)
    t = trainers.ADAG(_spec(), ps_transport="socket", directory=True,
                      fault_plan=FaultPlan(kill_directory_after_ops=5), **kw)
    assert (t.directory, t.directory_standby, t.ps_directory) \
        == (True, True, None)


def test_trainer_ps_directory_discovers_external_fleet():
    """``ps_directory=``: the trainer knows only the directory's seeds;
    the fleet this test hosts is discovered, trained against and its
    center pulled, exactly once."""
    probe = trainers.ADAG(_spec(), num_workers=2, **_KW)
    params, _ = probe.spec.init_np(probe.seed)
    ps = _start(SocketParameterServer(params, probe.allocate_merge_rule(),
                                      2))
    dsrv = _start(DirectoryServer(default_ttl=None))
    try:
        dc = DirectoryClient([(dsrv.host, dsrv.port)])
        dc.publish("ps", "shard-00", "127.0.0.1", ps.port, epoch=0,
                   meta={"num_shards": 1})
        dc.close()
        t = trainers.ADAG(_spec(), learning_rate=0.1, num_workers=2,
                          batch_size=32, communication_window=2,
                          num_epoch=1, ps_transport="socket",
                          ps_directory=f"{dsrv.host}:{dsrv.port}", **_KW)
        center = _watchdog(lambda: t.train(Dataset.from_arrays(
            *blobs(n=256)), shuffle=False))
        assert ps.num_updates == t.resilience_stats_["logical_commits"] > 0
        live = ps.get_model()
        for k in live:
            np.testing.assert_array_equal(center[k].numpy(), live[k])
        assert dsrv.stats()["lookups"] >= 2   # a lookup a worker
    finally:
        dsrv.stop()
        ps.stop()


@pytest.mark.parametrize("cls_name", ["ADAG", "DOWNPOUR"])
def test_chaos_kill_shard_and_directory_primary(cls_name, tmp_path):
    """The acceptance: PS shard 1 and the directory primary killed
    mid-run, with a mid-run elastic joiner whose sharded client is minted
    from a lookup. The run completes exactly once a shard, both failovers
    are real, each shard's active log replays to its final part bit for
    bit (tolerance 0), and the WAL root verifies, naming the directory."""
    from distkeras_tpu_torch import sharding
    from distkeras_tpu_torch.resilience.wal import recover_ps_state

    wal = str(tmp_path / "wal")
    plan = FaultPlan(seed=3, drop_recv=0.01, max_faults=10,
                     kill_ps_after_commits=8, kill_shard_id=1,
                     kill_directory_after_ops=25,
                     join_worker_at_window={0: 2})
    t = getattr(trainers, cls_name)(
        _spec(), learning_rate=0.05, num_workers=2, batch_size=16,
        communication_window=2, num_epoch=2, ps_transport="socket",
        ps_num_shards=2, ps_chain_length=2, ps_wal_dir=wal,
        ps_failover_timeout=0.5, heartbeat_interval=0.1, elastic=True,
        directory=True, fault_plan=plan,
        retry_policy=RetryPolicy(max_attempts=200, base_delay=0.005,
                                 max_delay=0.2, deadline=120), **_KW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # both failover warnings
        with plan:
            center = _watchdog(lambda: t.train(
                Dataset.from_arrays(*blobs(n=768)), shuffle=True))
    fs = plan.stats()
    assert fs["ps_kills"] == 1 and fs["directory_kills"] == 1
    assert fs["joins"] == 1
    rs = t.resilience_stats_
    assert rs["ps_failover"]["failovers"] >= 1
    assert rs["directory"]["failover"]["failovers"] >= 1
    s = t.ps_stats_
    assert s["num_updates"] == s["num_updates_max"] \
        == rs["logical_commits"]
    assert rs["elastic"]["assigner"]["exactly_once"]
    assert rs["elastic"]["joined"] == 1
    assert rs["directory"]["primary"]["lookups"] + fs["directory_ops"] > 0
    # the promoted link re-registered shard 1 at its bumped epoch
    entries = {e["key"]: e for e in
               rs["directory"]["membership"]["entries"]}
    assert set(entries) == {"shard-00", "shard-01"}
    assert entries["shard-01"]["epoch"] >= 1
    params, _ = t.spec.init_np(t.seed)
    sp = sharding.ShardPlan(params, 2)
    rule = t.allocate_merge_rule()
    per = rs["ps_failover"]["per_shard"]
    parts = []
    for sid in range(2):
        d = sharding.shard_wal_dir(wal, sid)
        if per[sid]["failovers"] \
                and per[sid]["failover_log"][0]["via"] == "standby":
            d = sharding.chain_wal_dir(wal, sid, 1)
        st = recover_ps_state(d, rule, t.num_workers, None,
                              template=sp.shard_template(params, sid))
        assert st is not None, d
        parts.append(st["center"])
    replayed = sp.join(parts)
    assert sorted(replayed) == sorted(center)
    for k in center:
        np.testing.assert_array_equal(np.asarray(replayed[k]),
                                      center[k].numpy())
    rep = walmod.verify_tree(wal)
    assert rep["ok"], rep
    assert rep["num_directory_dirs"] >= 1
    assert _final_loss(t) < 1.5


# -- the serving router -------------------------------------------------------------


VOCAB, MAXLEN = 64, 64
CFG = dict(vocab=VOCAB, maxlen=MAXLEN, dim=32, heads=4, depth=2,
           pos_embedding="rope", kv_heads=2)


@pytest.fixture(scope="module")
def lm():
    from distkeras_tpu.models.lm import transformer_lm
    from distkeras_tpu_torch.convert import params_from_jax
    from distkeras_tpu_torch.models.lm import TransformerLM

    spec = transformer_lm(dtype=jnp.float32, **CFG)
    params, _ = spec.init_np(0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    params_from_jax(params, model)
    return spec, params, model.eval()


def _serve_replica(model, seeds, key):
    from distkeras_tpu_torch.serving import GenerationEngine, GenerationServer

    eng = GenerationEngine(model, max_batch=4, block_size=8, max_queue=32,
                           device="cpu")
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.start()
    srv.register_with(seeds, key=key, ttl=1.0)
    return srv


def test_router_prefix_affinity_and_replica_kill(lm):
    """Two replicas registered through ``register_with``: repeats of one
    prefix land on one replica, distinct prefixes reach both, ten
    concurrent requests survive one replica killed mid-stream with every
    stream complete and equal (tolerance 0) to the JAX package's dense
    greedy ``generate``, and the dead replica leaves the directory within
    three TTLs."""
    from distkeras_tpu.models.lm import generate

    spec, params, model = lm
    dsrv = _start(DirectoryServer(default_ttl=None))
    seeds = [(dsrv.host, dsrv.port)]
    a = _serve_replica(model, seeds, "a")
    b = _serve_replica(model, seeds, "b")
    router = RoutedGenerationClient(directory=seeds, prefix_tokens=4,
                                    cooldown=0.5)
    try:
        assert set(router.replicas) == {"a", "b"}
        rng = np.random.default_rng(0)
        prefixes = [rng.integers(0, VOCAB, (4,)).astype(np.int32)
                    for _ in range(6)]
        for _ in range(2):
            router.generate(np.concatenate([
                prefixes[0], rng.integers(0, VOCAB, (3,)).astype(np.int32),
            ]), max_new_tokens=2)
        before = dict(router.stats()["routed"])
        for _ in range(3):
            router.generate(np.concatenate([
                prefixes[0], rng.integers(0, VOCAB, (3,)).astype(np.int32),
            ]), max_new_tokens=2)
        after = router.stats()["routed"]
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        assert sum(1 for v in moved.values() if v) == 1, moved
        for p in prefixes:
            router.generate(p, max_new_tokens=2)
        spread = router.stats()["routed"]
        assert all(spread.get(k, 0) > 0 for k in ("a", "b")), spread

        results: dict = {}
        errs: dict = {}
        prompts = []

        def go(i, prompt):
            try:
                results[i] = router.generate(prompt, max_new_tokens=12)
            except BaseException as e:  # noqa: BLE001 — asserted empty
                errs[i] = e

        threads = []
        for i in range(10):
            p = np.concatenate([
                prefixes[i % len(prefixes)],
                rng.integers(0, VOCAB, (5,)).astype(np.int32)])
            prompts.append(p)
            th = threading.Thread(target=go, args=(i, p))
            th.start()
            threads.append(th)
        time.sleep(0.05)          # streams in flight
        a._crash(timeout=2)
        for th in threads:
            th.join(timeout=90)
        assert not errs, errs
        assert len(results) == 10
        assert router.stats()["failovers"] >= 1
        for i in range(10):
            oracle = np.asarray(generate(spec, params, prompts[i][None],
                                         12))[0, len(prompts[i]):]
            np.testing.assert_array_equal(results[i], oracle)
        dc = DirectoryClient(seeds)
        try:
            assert _wait(lambda: all(e["key"] != "a"
                                     for e in dc.lookup("serve")), 3.0)
        finally:
            dc.close()
        router.refresh(force=True)
        assert set(router.replicas) == {"b"}
    finally:
        router.close()
        b._crash(timeout=2)
        for srv in (a, b):
            srv.stop(drain=False, timeout=2)
        dsrv.stop()


def test_jax_router_routes_as_the_port_router(lm):
    """The same two replicas seen by each package's router: the pinned
    route keys are equal, each prefix goes to the same replica, and the
    JAX package's router gets the same streams (tolerance 0) from the
    port's replicas."""
    _, _, model = lm
    dsrv = _start(DirectoryServer(default_ttl=None))
    seeds = [(dsrv.host, dsrv.port)]
    reps = [_serve_replica(model, seeds, k) for k in ("a", "b")]
    mine = RoutedGenerationClient(directory=seeds, prefix_tokens=4)
    theirs = jdir.RoutedGenerationClient(directory=seeds, prefix_tokens=4)
    try:
        rng = np.random.default_rng(1)
        for i in range(8):
            p = rng.integers(0, VOCAB, (9,)).astype(np.int32)
            assert prefix_route_key(p, 4) == jdir.prefix_route_key(p, 4)
            assert mine._route_order(p) == theirs._route_order(p)
            np.testing.assert_array_equal(
                mine.generate(p, max_new_tokens=6),
                theirs.generate(p, max_new_tokens=6))
        assert mine.stats()["routed"] == theirs.stats()["routed"]
    finally:
        mine.close()
        theirs.close()
        for srv in reps:
            srv.stop()
        dsrv.stop()


def test_replica_ring_weights_and_hit_affinity():
    from distkeras_tpu.directory.router import _ReplicaRing as JRing

    keys = [f"rep-{i}" for i in range(3)]
    base = _ReplicaRing(keys, vnodes=32)
    ones = _ReplicaRing(keys, vnodes=32, weights={k: 1.0 for k in keys})
    # weight 1.0 everywhere is the unweighted ring point for point
    assert base._hashes == ones._hashes and base._owners == ones._owners
    hot = _ReplicaRing(keys, vnodes=32, weights={"rep-0": 2.0})
    ref = JRing(keys, vnodes=32, weights={"rep-0": 2.0})
    assert hot._hashes == ref._hashes and hot._owners == ref._owners
    points = {k: sum(1 for o in hot._owners if o == k) for k in keys}
    assert points["rep-0"] == 64
    assert points["rep-1"] == points["rep-2"] == 32
    rng = np.random.default_rng(0)
    owners = [next(hot.successors(int(h))) for h in
              rng.integers(0, 2**63 - 1, (2000,))]
    assert owners.count("rep-0") > owners.count("rep-1")
    floor = _ReplicaRing(keys, vnodes=32, weights={"rep-0": 0.0})
    assert sum(1 for o in floor._owners if o == "rep-0") == 1
    with pytest.raises(ValueError, match="hit_affinity"):
        RoutedGenerationClient(replicas={"a": ("127.0.0.1", 1)},
                               hit_affinity=-0.5)


def test_serving_register_with_withdraws_on_stop(lm):
    """``register_with`` publishes the replica with the engine's
    ``model_version`` and ``prefix_hit_rate`` (0 and 0.0, as the JAX
    engine's without a swap or a prefix cache); ``stop`` withdraws it and
    joins the renewer."""
    _, _, model = lm
    dsrv = _start(DirectoryServer(default_ttl=None))
    c = DirectoryClient([(dsrv.host, dsrv.port)])
    try:
        srv = _serve_replica(model, [(dsrv.host, dsrv.port)], "r")
        entries = c.lookup("serve")
        assert [(e["key"], e["port"], e["ttl"], e["meta"])
                for e in entries] == [
            ("r", srv.port, 1.0,
             {"model_version": 0, "prefix_hit_rate": 0.0})]
        renewer = srv._dir_renewer
        assert renewer.is_alive()
        srv.stop()
        assert c.lookup("serve") == []    # a clean stop withdraws
        assert not renewer.is_alive()
    finally:
        c.close()
        dsrv.stop()


# -- the shm rendezvous -----------------------------------------------------------------


def test_shm_rendezvous_registers_and_withdraws_segments():
    """Segments minted while a directory rendezvous is installed are
    found by name through the directory, every unlink withdraws, and the
    process registry is the fallback again after uninstall."""
    dsrv = _start(DirectoryServer(default_ttl=None))
    dc = DirectoryClient([(dsrv.host, dsrv.port)])
    uninstall = install_shm_rendezvous(dc, host="127.0.0.1")
    seg = None
    try:
        seg = tshm.mint_segment("dktshm_rdvtest", 4096)
        names = [e["key"] for e in dc.shm_segments()]
        assert seg.name in names
        entry = dc.lookup("shm", seg.name)[0]
        assert (entry["host"], entry["meta"]["bytes"]) \
            == ("127.0.0.1", seg.size)
        seg.close()
        seg.unlink()
        tshm.unregister_segment(seg.name)
        assert dc.shm_segments() == []
        seg = None
    finally:
        if seg is not None:
            seg.close()
            seg.unlink()
            tshm.unregister_segment(seg.name)
        uninstall()
        assert tshm._RENDEZVOUS is None
        dc.close()
        dsrv.stop()
