"""The port's shared-memory (``shm.py``) and native (``native_ps.py``,
``native/dkps.cpp``) parameter-server transports, held against the port's
Python PS and against the JAX package on the CPU.

The port builds its own ``libdkps`` once per process with ``g++`` (a build
error fails the test, never skips it). Tolerances: bit-equal wherever the
JAX package's test pins bits (shm against in-process; the native server
and client against the JAX package's, both ways; the int8 wire against
``Int8Codec.decode``); the native fold against the Python PS's numpy fold
within rtol 1e-5 / atol 1e-6 (``center += scale · d`` in C++ against the
rule's numpy expression, as ``tests/test_native_ps.py`` holds it); a
trainer on native against one on socket within rtol 5e-5 / atol 1e-6.

The port's segments are named ``dktshm*`` and its leak checks scan only
that prefix, so they run beside the JAX package's ``dkshm`` checks.
"""

import ctypes
import os
import socket
import struct
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest

from distkeras_tpu.parallel import compression as jcomp
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import native, shm, trainers, utils
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.networking import FencedEpochError, PeerDeadError
from distkeras_tpu_torch.parallel import compression as tcomp
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.shm import ShmParameterServer, ShmPSClient
from tests.test_torch_pipeline import _equal, _jax_native, _run
from tests.test_torch_ps import TIMEOUT, _spec, blobs


@pytest.fixture(scope="module")
def tnative():
    native.load_dkps()   # builds libdkps; a failure fails the test
    from distkeras_tpu_torch import native_ps

    return native_ps


def _server(mod, center, rule, num_workers):
    ps = mod.NativeSocketParameterServer(center, rule, num_workers)
    ps.initialize()
    ps.start()
    return ps


def _client(mod, ps, worker_id, **kw):
    return mod.NativePSClient("127.0.0.1", ps.port, worker_id,
                              mod.FlatSpec(ps.get_model()), **kw)


# -- native: the build, FlatSpec ----------------------------------------------


def test_native_builds_into_the_ports_own_directory(tnative):
    """The library lands in ``distkeras_tpu_torch/_build/``, never in the
    JAX package's build directory, and a second build reuses it."""
    import distkeras_tpu_torch

    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(distkeras_tpu_torch.__file__), "_build")
    assert native.build() == 0.0


def test_flatspec_roundtrip_and_the_jax_package_leaf_order(tnative):
    """``test_native_ps.py:49``: a round trip keeps every leaf's shape and
    dtype, and the flat vector of a nested tree is the JAX package's."""
    rng = np.random.default_rng(0)
    tree = {"dense": {"kernel": np.arange(12, dtype=np.float32)
                      .reshape(3, 4), "bias": np.ones(4, np.float32)},
            "scale": np.float32(2.5),
            "emb": rng.normal(size=(5, 2)).astype(np.float32),
            "blocks": [{"w": rng.normal(size=(3,)).astype(np.float32)},
                       {"w": rng.normal(size=(2, 2)).astype(np.float32)}]}
    spec = tnative.FlatSpec(tree)
    vec = spec.flatten(tree)
    assert vec.dtype == np.float32 and vec.shape == (12 + 4 + 1 + 10 + 7,)
    back = spec.unflatten(vec)
    for a, b in zip(utils.flatten(back)[0], utils.flatten(tree)[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jvec = _jax_native().FlatSpec(tree).flatten(tree)
    np.testing.assert_array_equal(vec, jvec)


# -- native against the port's Python PS --------------------------------------


@pytest.mark.parametrize("rule_factory", [
    lambda: tr.ADAGMerge(), lambda: tr.DownpourMerge(),
    lambda: tr.ElasticAverageMerge(alpha=0.05), lambda: tr.DynSGDMerge(),
], ids=["adag", "downpour", "elastic", "dynsgd"])
def test_native_fold_matches_the_python_ps(tnative, rule_factory):
    """``test_native_ps.py:75``: the same pulls and commits fold to the
    Python PS's center (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(3)
    center = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    W = 3
    oracle = tps.ParameterServer(center, rule_factory(), W)
    ps = _server(tnative, center, rule_factory(), W)
    try:
        clients = [_client(tnative, ps, i) for i in range(W)]
        script = [(0, "pull"), (1, "pull"), (1, "commit"), (0, "commit"),
                  (2, "pull"), (2, "commit"), (0, "pull"), (0, "commit")]
        for wid, action in script:
            if action == "pull":
                got, want = clients[wid].pull(), oracle.pull(wid)
                np.testing.assert_allclose(got["w"], want["w"], rtol=1e-6)
            else:
                payload = {"w": rng.normal(size=(4, 3)).astype(np.float32),
                           "b": rng.normal(size=(3,)).astype(np.float32)}
                clients[wid].commit(wid, payload)
                oracle.commit(wid, payload)
        assert ps.num_updates == oracle.num_updates == 4
        got, want = ps.get_model(), oracle.get_model()
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6)
        assert ps.stats()["commits"] == 4
        for c in clients:
            c.close()
    finally:
        ps.stop()


def test_native_dynsgd_staleness_over_the_wire(tnative):
    """``test_native_ps.py:111``: worker 0 pulls at version 0, two commits
    land before its own → τ 2 → scale 1/3."""
    ps = _server(tnative, {"w": np.zeros(1, np.float32)}, tr.DynSGDMerge(),
                 3)
    try:
        c0, c1, c2 = (_client(tnative, ps, i) for i in range(3))
        c0.pull()
        c1.pull()
        c1.commit(1, {"w": np.array([3.0], np.float32)})
        c2.pull()
        c2.commit(2, {"w": np.array([4.0], np.float32)})
        c0.commit(0, {"w": np.array([3.0], np.float32)})
        np.testing.assert_allclose(ps.get_model()["w"], [8.0], rtol=1e-6)
        for c in (c0, c1, c2):
            c.close()
    finally:
        ps.stop()


def _ring_script(mod, jax_side: bool, wal_dir: str):
    """Exchanges with seqnos, a pull and a plain commit against an armed
    native server with a WAL; returns ``(port, scraped spans)``."""
    rule = (jr if jax_side else tr).DynSGDMerge()
    ps = mod.NativeSocketParameterServer({"w": np.zeros(4, np.float32)},
                                         rule, 2, wal_dir=wal_dir,
                                         wal_group_window=1)
    ps.initialize()
    ps.start()
    try:
        ps.set_trace(True)
        cs = [_client(mod, ps, i) for i in range(2)]
        for k in range(1, 4):
            for i, c in enumerate(cs):
                c.exchange(i, {"w": np.full(4, k, np.float32)}, seq=k)
        cs[0].exchange(0, {"w": np.ones(4, np.float32)})   # no seqno
        cs[1].pull()
        cs[1].commit(1, {"w": np.ones(4, np.float32)})
        for c in cs:
            c.close()
        return ps.port, ps.scrape_trace_events()
    finally:
        ps.stop()


def test_native_span_ring_scrapes_tracer_shaped_events(tnative, tmp_path):
    """The C++ span ring's scrape has the JAX package's shape: tracer
    dicts with ``cat`` "dkps", ``tid`` ``1 + (port & 0xFFFF)``, ``tname``
    ``dkps:<port>`` and the corr rebuilt from the wire's worker id and
    seqno (``w<id>:s<seq>``, ``w<id>`` without a seqno, none for the
    flusher's fsyncs), and the same spans as the JAX server's for the
    same requests."""
    import re

    from distkeras_tpu_torch.observability import trace as ttrace

    out = {}
    for side, mod in (("port", tnative), ("jax", _jax_native())):
        port, evs = _ring_script(mod, side == "jax",
                                 str(tmp_path / side))
        assert evs, side
        for e in evs:
            assert set(e) == {"name", "cat", "corr", "t0_ns", "dur_ns",
                              "tid", "tname"}, e
            assert e["cat"] == "dkps" and e["dur_ns"] >= 0
            assert e["tid"] == 1 + (port & 0xFFFF)
            assert e["tname"] == f"dkps:{port}"
            if e["name"] == "wal.fsync":
                assert e["corr"] is None
            else:
                assert re.fullmatch(r"w\d+(:s\d+)?", e["corr"]), e
        # the flusher's fsync count is the timing's: compared apart
        assert any(e["name"] == "wal.fsync" for e in evs), side
        out[side] = sorted((e["name"], e["corr"]) for e in evs
                           if e["name"] != "wal.fsync")
    assert out["port"] == out["jax"]
    folds = [c for n, c in out["port"] if n == "ps.fold"]
    assert sorted(folds) == sorted(
        [f"w{i}:s{k}" for i in range(2) for k in range(1, 4)] + ["w0"])
    # the dicts are add_events' contract: they land in the recorder as is
    ttrace.enable()
    try:
        ttrace.add_events(evs)
        got = [e for e in ttrace.events() if e["cat"] == "dkps"]
        assert len(got) == len(evs)
    finally:
        ttrace.disable()


# -- native wire compatibility with the JAX package ---------------------------


def _native_script(server_mod, client_mod, pull_compression):
    """Pulls, raw and int8 commits, lagged and plain exchanges of three
    workers against one native server; every reply and the center."""
    rng = np.random.default_rng(11)
    center = {"dense": {"bias": rng.normal(size=(5,)).astype(np.float32),
                        "kernel": rng.normal(size=(6, 5)).astype(np.float32)},
              "gain": rng.normal(size=(3,)).astype(np.float32)}
    rule = (tr if server_mod.__name__.startswith("distkeras_tpu_torch")
            else jr).DynSGDMerge()
    codec = (tcomp if client_mod.__name__.startswith("distkeras_tpu_torch")
             else jcomp).Int8Codec(min_size=1)
    ps = _server(server_mod, center, rule, 3)
    try:
        cs = [client_mod.NativePSClient(
            "127.0.0.1", ps.port, w, client_mod.FlatSpec(center),
            pull_compression=pull_compression) for w in range(3)]
        got = [c.pull() for c in cs]
        for k in range(9):
            w = k % 3
            d = utils.host_tree_map(
                lambda a: (rng.normal(size=a.shape) * 0.1)
                .astype(np.float32), center)
            if k % 3 == 1:
                cs[w].commit(w, codec.encode(d))
            else:
                got.append(cs[w].exchange(w, d, lag=k % 2 == 0))
        for c in cs:
            c.close()
        stats = ps.stats()
        return got, ps.get_model(), {k: stats[k] for k in (
            "commits", "pulls", "compressed_pulls", "fused_exchanges",
            "num_updates", "bytes_in", "bytes_out")}
    finally:
        ps.stop()


@pytest.mark.parametrize("pull_compression", [None, "int8"])
@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_native_wire_interop_with_the_jax_package(tnative, direction,
                                                  pull_compression):
    """The port's native server with the JAX package's ``NativePSClient``
    and the reverse, both libraries loaded in this process from their own
    paths: every reply, the center and the counters equal the JAX pair's
    bit for bit."""
    jnative = _jax_native()
    ref = _native_script(jnative, jnative, pull_compression)
    cross = (_native_script(tnative, jnative, pull_compression)
             if direction == "jax_client_port_server"
             else _native_script(jnative, tnative, pull_compression))
    assert len(ref[0]) == len(cross[0]) == 9
    for a, b in zip(ref[0], cross[0]):
        _equal(a, b)
    _equal(ref[1], cross[1])
    assert ref[2] == cross[2] and ref[2]["num_updates"] == 9


# -- native refusals and the int8 wire ----------------------------------------


def test_native_refuses_custom_merge_rules(tnative):
    """``test_native_ps.py:227``."""
    class Weird(tr.MergeRule):
        def fold(self, center, commit, num_workers, staleness):
            return center

    with pytest.raises(ValueError, match="socket"):
        tnative.fold_mode(Weird(), 4)
    with pytest.raises(ValueError, match="socket"):
        _server(tnative, {"w": np.zeros(2, np.float32)}, Weird(), 1)


def test_native_refuses_garbage_and_wrong_length(tnative):
    """``test_native_ps.py:155``: a garbled handshake is dropped, a wrong
    vector length refused, and the server keeps serving."""
    ps = _server(tnative, {"w": np.zeros(8, np.float32)}, tr.DownpourMerge(),
                 1)
    try:
        s = socket.create_connection(("127.0.0.1", ps.port), timeout=5)
        s.sendall(b"EVIL!\n" + struct.pack("<IQ", 0, 8))
        try:
            assert s.recv(1) == b""
        except ConnectionResetError:
            pass
        s.close()
        with pytest.raises(ConnectionError, match="vector length"):
            tnative.NativePSClient("127.0.0.1", ps.port, 0,
                                   type("S", (), {"n": 9999})())
        c = _client(tnative, ps, 0)
        c.commit(0, {"w": np.ones(8, np.float32)})
        np.testing.assert_array_equal(ps.get_model()["w"], 1.0)
        c.close()
    finally:
        ps.stop()


def test_native_int8_commit_wire_equals_the_codec_decode(tnative):
    """``test_native_ps.py:275``: a segmented int8 commit folds exactly
    the tree ``Int8Codec.decode`` gives (bit-equal at DOWNPOUR's scale 1
    from a zero center)."""
    rng = np.random.default_rng(0)
    center = {"dense": {"kernel": np.zeros((16, 8), np.float32),
                        "bias": np.zeros(8, np.float32)},
              "gain": np.zeros(3, np.float32)}
    ps = _server(tnative, center, tr.DownpourMerge(), 1)
    try:
        c = _client(tnative, ps, 0)
        codec = tcomp.Int8Codec(min_size=1)
        delta = utils.host_tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), center)
        blob = codec.encode(delta)
        c.pull()
        c.commit(0, blob)
        _equal(ps.get_model(), codec.decode(blob))
        assert ps.num_updates == 1
        assert ps.stats()["bytes_in"] < 4 * (16 * 8 + 8 + 3)
        c.close()
    finally:
        ps.stop()


def test_native_int8_refuses_malformed_segments(tnative):
    """``test_native_ps.py:307``: segment lengths that do not sum to the
    pinned n drop the connection without folding."""
    ps = _server(tnative, {"w": np.zeros(64, np.float32)},
                 tr.DownpourMerge(), 1)
    try:
        c = _client(tnative, ps, 0)
        qv = np.ones(64, np.int8)
        lens = np.asarray([100], np.uint64)
        scales = np.ones(1, np.float32)
        rc = c._lib.dkps_client_commit_int8(
            c._handle, qv.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1)
        assert rc != 0
        assert ps.num_updates == 0
        np.testing.assert_array_equal(ps.get_model()["w"], 0.0)
        c.close()
    finally:
        ps.stop()


def test_native_later_layers_name_their_item(tnative, tmp_path):
    """The native server's EMA (once refused naming A8), WAL, fencing
    epoch and leases (once refused naming A7.6) now work: a seq'd commit
    and its replay fold once, the EMA folds once, a fenced client's commit
    is refused, a lease lapses into an eviction, and the C++ log recovers
    to the live center and EMA."""
    center = {"w": np.zeros(2, np.float32)}
    ps = tnative.NativeSocketParameterServer(
        center, tr.DownpourMerge(), 1, wal_dir=str(tmp_path), fence_epoch=2,
        lease_timeout=0.2, ema_decay=0.5)
    ps.initialize()
    ps.start()
    try:
        assert ps.fence_epoch == 2
        c = _client(tnative, ps, 0, epoch=2)
        d = {"w": np.ones(2, np.float32)}
        c.commit(0, d, seq=1)
        c.commit(0, d, seq=1)                   # the replay: a duplicate
        c.epoch = 1
        with pytest.raises(FencedEpochError):
            c.commit(0, d, seq=2)
        assert c.heartbeat() is False           # registered
        s = ps.stats()
        assert (s["num_updates"], s["dup_commits"], s["fenced_commits"],
                s["heartbeats"]) == (1, 1, 1, 1)
        deadline = time.monotonic() + TIMEOUT
        while ps.stats()["evicted_workers"] == 0:
            assert time.monotonic() < deadline, "the lease never lapsed"
            time.sleep(0.05)
        assert ps.stats()["active_workers"] == 0
        live, live_ema = ps.get_model(), ps.get_ema()
        # one fold from 0 to 1 at decay 0.5: the EMA is halfway
        np.testing.assert_array_equal(live_ema["w"], np.full(2, 0.5,
                                                             np.float32))
        c.close()
    finally:
        ps.stop()
    from distkeras_tpu_torch.resilience.wal import recover_ps_state

    state = recover_ps_state(str(tmp_path), tr.DownpourMerge(), 1, 0.5,
                             template=center)
    np.testing.assert_array_equal(state["center"]["w"], live["w"])
    np.testing.assert_array_equal(state["ema"]["w"], live_ema["w"])
    assert state["fence_epoch"] == 2 and state["num_updates"] == 1


def _native_lease_script(mod, rules):
    """Leases of 0.3 s on a native server. Phase 1: worker 0 heartbeats
    once, then commits every 0.1 s for 1.2 s (four leases) while worker 1
    heartbeats after each commit (each heartbeat runs the expiry scan).
    Phase 2: worker 0 heartbeats, commits every 0.1 s for 0.5 s with no
    scan, worker 1's heartbeat scans, and worker 0 replays its last
    commit, as a client does whose ACK was lost. Returns (phase 1's
    evictions, worker 0 still leased after it, the replay's extra
    folds)."""
    ps = mod.NativeSocketParameterServer({"w": np.zeros(2, np.float32)},
                                         rules.DownpourMerge(), 2,
                                         lease_timeout=0.3)
    ps.initialize()
    ps.start()
    try:
        c0, c1 = (_client(mod, ps, i) for i in range(2))
        for c in (c0, c1):
            c.set_timeout(TIMEOUT)
            c.heartbeat()
        d = {"w": np.ones(2, np.float32)}
        seq = 0
        for _ in range(12):
            seq += 1
            c0.commit(0, d, seq=seq)
            c1.heartbeat()
            time.sleep(0.1)
        s = ps.stats()
        evicted, leased = s["evicted_workers"], s["active_workers"] == 2
        c0.heartbeat()
        for _ in range(5):
            seq += 1
            c0.commit(0, d, seq=seq)
            time.sleep(0.1)
        c1.heartbeat()
        before = ps.num_updates
        c0.commit(0, d, seq=seq)            # the replay of a lost ACK
        extra = ps.num_updates - before
        for c in (c0, c1):
            c.close()
        return evicted, leased, extra
    finally:
        ps.stop()


def test_native_lease_renews_on_every_request(tnative):
    """The port's C++ core extends a leased worker's lease on each pull,
    commit and exchange, as the Python servers do
    (``WorkerRegistry.touch``): a worker that commits every 0.1 s and
    never heartbeats outlives four 0.3 s leases, and a replay after its
    lease would have lapsed is refused, so the commit folds once. The JAX
    package's core renews by heartbeats only (``ROADMAP.md`` queue C): it
    evicts the committing worker, the eviction retires its dedup entry,
    and the replay folds a second time."""
    assert _native_lease_script(tnative, tr) == (0, True, 0)
    evicted, leased, extra = _native_lease_script(_jax_native(), jr)
    assert evicted >= 1 and not leased and extra == 1


def test_native_evicted_count_runs_no_expiry_pass(tnative, tmp_path):
    """``evicted_count()`` reads the core's evictions without the forced
    expiry pass of ``stats()``: a lapsed lease stays uncounted (and
    unlogged) until a pass runs, then counts once, and its evict record
    drains from ``wal_pending()`` within the flusher's interval."""
    ps = tnative.NativeSocketParameterServer(
        {"w": np.zeros(2, np.float32)}, tr.DownpourMerge(), 1,
        lease_timeout=0.2, wal_dir=str(tmp_path), wal_group_interval=0.05)
    ps.initialize()
    ps.start()
    try:
        c = _client(tnative, ps, 0)
        c.set_timeout(TIMEOUT)
        c.heartbeat()
        c.commit(0, {"w": np.ones(2, np.float32)}, seq=1)
        assert ps.wal_pending() == 0     # the commit's ACK waited on fsync
        time.sleep(0.3)                  # the lease lapses; no pass runs
        before = ps.evicted_count()
        after = ps.stats()["evicted_workers"]
        counted = ps.evicted_count()
        deadline = time.monotonic() + 5.0
        while ps.wal_pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (before, after, counted, ps.wal_pending()) == (0, 1, 1, 0)
        c.close()
    finally:
        ps.stop()


def test_native_trainer_equals_the_socket_trainer(tnative):
    """``test_native_ps.py:253``: one DOWNPOUR worker, unshuffled, on the
    native transport ends where the socket transport does (rtol 5e-5,
    atol 1e-6), and four workers learn."""
    _, a = _run(ps_transport="socket")
    _, b = _run(ps_transport="native")
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=5e-5, atol=1e-6)
    t = trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", learning_rate=0.1,
                      num_workers=2, batch_size=32, communication_window=2,
                      num_epoch=2, backend="ps", ps_transport="native",
                      compression="int8", device="cpu")
    t.train(Dataset.from_arrays(*blobs(n=1024)), shuffle=True)
    assert float(np.mean(t.history.losses()[-3:])) < 0.6
    assert t.ps_stats_["commits"] == 32


# -- shm: the rings -----------------------------------------------------------

_PAIR_SEQ = iter(range(10_000))


def _port_entries():
    """This process's live segments: the servers' (``dktshm_{pid}_n``) and
    the raw pairs' (``dktshm_test_{pid}_n``). The inventory scans the whole
    host, where other test processes mint their own at the same time."""
    mine = (f"{shm.SEGMENT_PREFIX}_{os.getpid()}_",
            f"{shm.SEGMENT_PREFIX}_test_{os.getpid()}_")
    return {s["name"] for s in shm.segment_inventory()["segments"]
            if s["name"].startswith(mine)}


def _conn_pair(ring_bytes=1 << 14):
    """A raw client/server endpoint pair over one fresh segment, no
    handler thread: the test drives both ends."""
    seg = shared_memory.SharedMemory(
        create=True,
        name=f"{shm.SEGMENT_PREFIX}_test_{os.getpid()}_{next(_PAIR_SEQ)}",
        size=shm._HDR_BYTES + 2 * ring_bytes)
    struct.pack_into("<Q", seg.buf, shm._OFF_MAGIC, shm._MAGIC)
    struct.pack_into("<Q", seg.buf, shm._OFF_CAP, ring_bytes)
    waker = shm._waker_for(seg.name)
    return seg, shm._ShmConn(seg, "client", waker), \
        shm._ShmConn(seg, "server", waker)


def _drop_pair(seg, cli, srv):
    cli.close()
    srv.close()
    shm._waker_drop(seg.name)
    try:
        seg.close()
    except BufferError:
        pass
    seg.unlink()


def test_pickle_lane_wraps_the_ring():
    """``test_shm.py:75``: frames through a 4 KiB ring cross its end and
    arrive byte-exact."""
    seg, cli, srv = _conn_pair(ring_bytes=1 << 12)
    try:
        for i in range(64):
            msg = {"action": "ping", "i": i, "blob": b"x" * (i * 7 % 97)}
            cli.send_msg(msg)
            got, raw, release = srv.recv_msg()
            assert release is None and raw is not None and got == msg
            srv.send_msg({"ok": True, "i": i})
            assert cli.recv_msg()[0] == {"ok": True, "i": i}
        assert cli._u64(cli._tx_head) > 1 << 12   # it wrapped
    finally:
        _drop_pair(seg, cli, srv)


def test_bulk_lane_views_then_release():
    """``test_shm.py:92``: ndarray leaves arrive as views over the ring,
    scalars ride the skeleton, and release frees the region."""
    seg, cli, srv = _conn_pair(ring_bytes=1 << 14)
    try:
        rng = np.random.default_rng(0)
        for _ in range(8):
            msg = {"action": "commit", "worker_id": 3,
                   "payload": {"w": rng.normal(size=(31,))
                               .astype(np.float32),
                               "q": {"b": np.arange(5, dtype=np.int8),
                                     "s": 0.25}}}
            cli.send_msg(msg, bulk=True)
            got, raw, release = srv.recv_msg()
            assert raw is None and release is not None
            assert got["worker_id"] == 3 and got["payload"]["q"]["s"] == 0.25
            np.testing.assert_array_equal(got["payload"]["w"],
                                          msg["payload"]["w"])
            np.testing.assert_array_equal(got["payload"]["q"]["b"],
                                          msg["payload"]["q"]["b"])
            assert not got["payload"]["w"].flags.owndata   # a ring view
            got = None
            release()
    finally:
        _drop_pair(seg, cli, srv)


def test_oversize_payload_spills_through_a_small_ring():
    """``test_shm.py:121``: a payload 50× the ring streams through the
    pickle lane byte-exact."""
    seg, cli, srv = _conn_pair(ring_bytes=1 << 12)
    try:
        big = np.arange(50_000, dtype=np.float32)
        out = {}

        def reader():
            out["msg"], _, out["rel"] = srv.recv_msg(copy=True)

        t = threading.Thread(target=reader)
        t.start()
        cli.send_msg({"payload": {"w": big}}, bulk=True)
        t.join(timeout=30)
        assert not t.is_alive() and out["rel"] is None
        np.testing.assert_array_equal(out["msg"]["payload"]["w"], big)
    finally:
        _drop_pair(seg, cli, srv)


def test_peer_death_mid_record_raises_and_never_wedges():
    """``test_shm.py:169``: a writer that dies after a record's word but
    before its payload leaves the reader a retryable PeerDeadError."""
    seg, cli, srv = _conn_pair()
    try:
        cli._skip_to_word_boundary_tx()
        cli._stream_tx([shm._WORD.pack((shm.FLAG_PKL << 56) | 100)])
        errs = []

        def reader():
            try:
                srv.recv_msg()
            except BaseException as e:
                errs.append(e)

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.05)
        cli.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert errs and isinstance(errs[0], PeerDeadError)
        assert errs[0].retryable and isinstance(errs[0], ConnectionError)
    finally:
        _drop_pair(seg, cli, srv)


def test_segments_unlink_on_close_and_stop_under_the_ports_prefix():
    """``test_shm.py:200``: a segment goes on client close, and on server
    stop for a client never closed; names carry the port's prefix, which
    the JAX package's ``dkshm`` scan never matches."""
    before = _port_entries()
    ps = ShmParameterServer({"w": np.zeros(64, np.float32)},
                            tr.DownpourMerge(), 2, ring_bytes=1 << 14)
    ps.initialize()
    c0, c1 = ShmPSClient(ps, 0), ShmPSClient(ps, 1)
    c0.pull()
    c1.pull()
    new = _port_entries() - before
    assert len(new) == 2
    assert all(n.startswith("dktshm_") and not n.startswith("dkshm")
               for n in new)
    c0.close()
    deadline = time.monotonic() + 5
    while len(_port_entries() - before) > 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(_port_entries() - before) == 1
    ps.stop()
    assert _port_entries() <= before
    with pytest.raises(ConnectionError):
        c1.pull()


# -- shm: trainers ------------------------------------------------------------


@pytest.mark.parametrize("name", ["ADAG", "DOWNPOUR", "DynSGD"])
def test_shm_trainer_bit_equal_to_inprocess(name):
    """``test_shm.py:257``."""
    _, a = _run(name)
    _, b = _run(name, ps_transport="shm")
    _equal(a, b)


def test_shm_trainer_bit_equal_int8_and_unfused_legs():
    """``test_shm.py:265``: int8 commits and pulls over the rings, fused
    and unfused, equal the in-process run bit for bit."""
    kw = dict(compression="int8", pull_compression="int8")
    _, a = _run(**kw)
    _, b = _run(ps_transport="shm", **kw)
    _, c = _run(ps_transport="shm", ps_fused_exchange=False, **kw)
    _equal(a, b)
    _equal(a, c)


def test_shm_four_concurrent_workers_count_exactly():
    """``test_shm.py:483``: four threads of fused integer exchanges end at
    an exact center, the counters agree, nothing leaks."""
    W, N = 4, 20
    before = _port_entries()
    ps = ShmParameterServer({"w": np.zeros(2048, np.float32)},
                            tr.DownpourMerge(), W, ring_bytes=1 << 16)
    ps.initialize()
    clients = [ShmPSClient(ps, i) for i in range(W)]
    errors = []

    def worker(i):
        try:
            clients[i].pull()
            for _ in range(N):
                out = clients[i].exchange(i, {"w": np.ones(2048,
                                                           np.float32)})
                assert float(out["w"][0]) == float(out["w"][-1])
        except BaseException as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        s = ps.stats()
        assert s["commits"] == s["fused_exchanges"] == W * N
        np.testing.assert_array_equal(ps.get_model()["w"], float(W * N))
    finally:
        for c in clients:
            c.close()
        ps.stop()
    assert _port_entries() <= before


# -- validation ---------------------------------------------------------------


def test_transport_and_pipeline_validation_matrix():
    """``test_shm.py:570`` and the JAX package's pipeline checks
    (``distkeras_tpu/trainers.py:941-986``), each a ValueError with its
    meaning; the valid configurations construct."""
    def mk(**kw):
        return trainers.DOWNPOUR(_spec(), backend=kw.pop("backend", "ps"),
                                 num_workers=1, device="cpu", **kw)

    for transport in ("inprocess", "socket", "shm", "native"):
        assert mk(ps_transport=transport,
                  ps_pipeline_depth=1).ps_pipeline_depth == 1
    mk(ps_transport="native", compression="int8")
    mk(ps_transport="native", ps_host="10.0.0.1")
    with pytest.raises(ValueError, match="colocated-only"):
        mk(ps_transport="shm", ps_host="10.0.0.1")
    with pytest.raises(ValueError, match="shm"):
        mk(ps_transport="bogus")
    with pytest.raises(ValueError, match="stock compression='int8'"):
        mk(ps_transport="native", compression="topk")
    with pytest.raises(ValueError, match="0 .serial. or 1"):
        mk(ps_pipeline_depth=2)
    with pytest.raises(ValueError, match="backend='ps' only"):
        mk(backend="collective", ps_pipeline_depth=1)
    with pytest.raises(ValueError, match="ps_fused_exchange=True"):
        mk(ps_pipeline_depth=1, ps_fused_exchange=False)
    with pytest.raises(ValueError, match="native"):
        mk(ps_transport="native", ps_pipeline_depth=1, compression="int8")
    # the directory's segment rendezvous (once refused naming A7.9)
    # installs and clears as the JAX package's does with the same
    # arguments; its callbacks are best effort, so even callbacks that
    # fail leave minting and unlinking working
    import distkeras_tpu.shm as jshm

    for mod in (jshm, shm):
        mod.set_rendezvous(None, None)
        assert mod._RENDEZVOUS == (None, None)
        mod.clear_rendezvous()
        assert mod._RENDEZVOUS is None
    seen = []
    publish = lambda name, size: seen.append(("publish", name, size))
    shm.set_rendezvous(publish, lambda name: seen.append(("withdraw", name)))
    shm.clear_rendezvous(lambda name, size: None)   # not ours: kept
    assert shm._RENDEZVOUS[0] is publish
    seg = shm.mint_segment("dktshm_rdv", 64)
    seg.close()
    seg.unlink()
    shm.unregister_segment(seg.name)
    shm.clear_rendezvous(publish)
    assert shm._RENDEZVOUS is None
    assert seen == [("publish", seg.name, seg.size), ("withdraw", seg.name)]
    shm.set_rendezvous(None, None)
    seg = shm.mint_segment("dktshm_rdv", 64)
    seg.close()
    seg.unlink()
    shm.unregister_segment(seg.name)
    shm.clear_rendezvous()


def test_shm_attach_standby_and_eviction_work():
    """``ShmParameterServer.attach_standby`` refuses a replication stream
    as the JAX server does (``distkeras_tpu/shm.py:814-820``: the shm
    transport is colocated-only), before it connects anywhere, and
    ``_on_evict`` works: a worker whose lease lapses is evicted and its
    ring segment unlinked while the other worker's stays."""
    center = {"w": np.zeros(64, np.float32), "b": np.zeros(3, np.float32)}
    ps = ShmParameterServer(center, tr.DynSGDMerge(), 2, lease_timeout=0.2)
    ps.initialize()
    rng = np.random.default_rng(0)
    try:
        with pytest.raises(NotImplementedError, match="colocated-only"):
            ps.attach_standby("127.0.0.1", 1)
        clients = [ShmPSClient(ps, i) for i in range(2)]
        for k in range(6):
            c = clients[k % 2]
            c.pull()
            c.commit(k % 2, {"w": rng.standard_normal(64).astype(np.float32),
                             "b": rng.standard_normal(3).astype(np.float32)},
                     seq=k + 1)
        clients[1].heartbeat()
        assert ps.num_updates == 6
        seg1 = next(r["seg"].name for r in ps._segments if r["wid"] == 1)
        deadline = time.monotonic() + TIMEOUT
        while ps.stats()["evicted_workers"] == 0:
            assert time.monotonic() < deadline, "the lease never lapsed"
            time.sleep(0.05)
        assert 1 not in ps._last_seq
        assert not os.path.exists(f"/dev/shm/{seg1}")  # unlinked
        assert any(r["wid"] == 0 for r in ps._segments)
        for c in clients:
            c.close()
    finally:
        ps.stop()


def test_shm_ring_occupancy_reads_every_connection():
    """``ShmParameterServer.ring_occupancy`` (the JAX server's
    ``distkeras_tpu/shm.py:889``): one record a connection, read off the
    mapped headers, each direction's used bytes within the capacity; the
    watchtower's PS source samples its max into
    ``shm.ring_occupancy_frac`` and the count into ``shm.segments``."""
    from distkeras_tpu_torch.observability.timeseries import (
        TimeSeriesStore,
        ps_source,
    )

    ps = ShmParameterServer({"w": np.zeros(64, np.float32)}, tr.ADAGMerge(),
                            2)
    ps.initialize()
    ps.start()
    try:
        cs = [ShmPSClient(ps, i) for i in range(2)]
        cs[0].pull()
        cs[1].commit(1, {"w": np.ones(64, np.float32)})
        occ = ps.ring_occupancy()
        assert sorted(r["worker_id"] for r in occ) == [0, 1]
        for r in occ:
            assert set(r) == {"name", "worker_id", "cap", "c2s_used",
                              "s2c_used", "frac"}
            assert r["cap"] == ps.ring_bytes
            assert 0 <= r["c2s_used"] <= r["cap"]
            assert 0 <= r["s2c_used"] <= r["cap"]
            assert r["frac"] == max(r["c2s_used"], r["s2c_used"]) / r["cap"]
        store = TimeSeriesStore()
        ps_source(ps)(store, 1.0)
        assert store.last("shm.segments") == 2
        assert store.last("shm.ring_occupancy_frac") == max(
            r["frac"] for r in ps.ring_occupancy())
        for c in cs:
            c.close()
    finally:
        ps.stop()
    assert ps.ring_occupancy() == []
