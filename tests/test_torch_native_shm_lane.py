"""The native parameter server's shm ring lane (``native_ps.py``:
``attach_shm``, ``NativePSClient.connect_shm``, ``set_model``, ``run``) and
the shm PS's refusal of a replication stream, held against the JAX
package's ``distkeras_tpu/native_ps.py`` and ``distkeras_tpu/shm.py`` on
the CPU.

Both packages' lanes drive the same C++ core (``native/dkps.cpp``) through
the same segment header (``shm.mint_segment``), so centers, pulls and
counters are held bit-equal: across the two lanes of one server, across
the two packages' servers, and against TCP. Rings smaller than one frame
make every frame wrap. The port's segments are ``dktshm_native*``; the
JAX server's lane is given the port's prefix here too (its
``mint_segment`` wrapped), so the JAX package's ``dkshm`` leak scans,
which may run at the same time in another process, never see a segment
of this file.
"""

import threading

import numpy as np
import pytest

from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import native, shm
from distkeras_tpu_torch.parallel import merge_rules as tr

N = 40_000                 # 160 KB a frame
RING = 1 << 15             # 32 KiB rings: every frame wraps
W, STEPS = 4, 5


@pytest.fixture(scope="module")
def tnative():
    native.load_dkps()   # builds libdkps; a failure fails the test
    from distkeras_tpu_torch import native_ps

    return native_ps


def _lane_entries():
    return {s["name"] for s in shm.segment_inventory()["segments"]
            if s["name"].startswith(f"{shm.SEGMENT_PREFIX}_native")}


def _center():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(200, 150)).astype(np.float32),
            "b": rng.normal(size=N - 200 * 150).astype(np.float32)}


def _deltas(seed, k):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(scale=0.01, size=(200, 150)).astype(np.float32),
             "b": rng.normal(scale=0.01, size=N - 200 * 150)
             .astype(np.float32)} for _ in range(k)]


def _server(mod, rule, num_workers, **kw):
    ps = mod.NativeSocketParameterServer(_center(), rule, num_workers, **kw)
    ps.initialize()
    ps.run()
    return ps


def _equal(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def _drive(clients, deltas_of):
    """Serial: each worker pulls, commits its first delta, then exchanges
    the rest, in a fixed round-robin order; returns every reply."""
    out = []
    for c in clients:
        out.append(c.pull())
    for step in range(STEPS):
        for i, c in enumerate(clients):
            d = deltas_of[i][step]
            if step == 0:
                c.commit(i, d)
            else:
                out.append(c.exchange(i, d, seq=step))
    return out


def test_shm_ps_refuses_a_standby_stream_as_the_jax_one_does():
    """``tests/test_shm.py:597-601``: the shm PS is colocated-only, so it
    refuses a replication stream with ``NotImplementedError``
    ("colocated-only") in both packages, before any connection is tried
    (the port's once inherited the socket server's ``attach_standby`` and
    opened the stream)."""
    from distkeras_tpu import shm as jshm

    for mod, rule in ((jshm, jr.DownpourMerge()), (shm, tr.DownpourMerge())):
        ps = mod.ShmParameterServer({"w": np.zeros(4, np.float32)}, rule, 1)
        with pytest.raises(NotImplementedError, match="colocated-only"):
            ps.attach_standby("127.0.0.1", 1)


def test_native_shm_lane_parity(tnative):
    """``tests/test_shm.py:531-563``: a lane client speaks the protocol
    (pull, commit, exchange, heartbeat) and sees the center a TCP client of
    the same server sees; the segment unlinks at stop."""
    before = _lane_entries()
    center = {"w": np.zeros(4096, np.float32)}
    ps = tnative.NativeSocketParameterServer(center, tr.DownpourMerge(), 2)
    ps.initialize()
    ps.start()
    try:
        c = tnative.NativePSClient.connect_shm(ps, 0)
        assert np.array_equal(c.pull()["w"], center["w"])
        delta = {"w": np.full(4096, 1.5, np.float32)}
        c.commit(0, delta)
        out = c.exchange(0, delta, seq=2)
        assert np.array_equal(out["w"], np.full(4096, 3.0, np.float32))
        assert c.heartbeat() in (True, False)
        tcp = tnative.NativePSClient("127.0.0.1", ps.port, 1, ps.spec)
        assert np.array_equal(tcp.pull()["w"], out["w"])  # one center
        tcp.close()
        assert len(_lane_entries() - before) == 1
        c.close()
    finally:
        ps.stop()
    assert _lane_entries() <= before


def test_lane_and_tcp_fold_the_same_wrapped_frames(tnative):
    """Two servers from one center under DynSGD: the same seeded deltas
    through lane clients on one (rings of 32 KiB against 160 KB frames)
    and TCP clients on the other leave bit-equal centers, replies and
    counts; a TCP client of the lane server pulls what a lane client
    pulls; int8 pull streams are equal on both lanes; ``set_model`` is
    read back bit-equal through the lane and restarts the EMA from the new
    center."""
    before = _lane_entries()
    deltas = [_deltas(10 + i, STEPS) for i in range(W)]
    a = _server(tnative, tr.DynSGDMerge(), W, ema_decay=0.9)
    b = _server(tnative, tr.DynSGDMerge(), W, ema_decay=0.9)
    try:
        lane = [tnative.NativePSClient.connect_shm(a, i, ring_bytes=RING)
                for i in range(W)]
        tcp = [tnative.NativePSClient("127.0.0.1", b.port, i, b.spec)
               for i in range(W)]
        ra, rb = _drive(lane, deltas), _drive(tcp, deltas)
        assert all(_equal(x, y) for x, y in zip(ra, rb))
        assert _equal(a.get_model(), b.get_model())
        assert _equal(a.get_ema(), b.get_ema())
        assert a.num_updates == b.num_updates == W * STEPS
        assert a.stats()["commits"] == b.stats()["commits"] == W * STEPS
        # one center, two lanes (each pull is mirrored on b, which keeps
        # the servers' pull versions, DynSGD's staleness bases, equal)
        probe = tnative.NativePSClient("127.0.0.1", a.port, W, a.spec)
        assert _equal(probe.pull(), lane[0].pull())
        probe.close()
        probe = tnative.NativePSClient("127.0.0.1", b.port, W, b.spec)
        assert _equal(probe.pull(), tcp[0].pull())
        probe.close()
        qa = tnative.NativePSClient.connect_shm(
            a, W, pull_compression="int8", ring_bytes=RING)
        qb = tnative.NativePSClient("127.0.0.1", b.port, W, b.spec,
                                    pull_compression="int8")
        for k in range(3):
            d = _deltas(99 + k, 1)[0]
            lane[0].commit(0, d)
            tcp[0].commit(0, d)
            assert _equal(qa.pull(), qb.pull())
        fresh = {k: v + 1.0 for k, v in _center().items()}
        a.set_model(fresh)
        assert _equal(lane[1].pull(), fresh)
        assert _equal(a.get_ema(), fresh)
        for c in lane + tcp + [qa, qb]:
            c.close()
    finally:
        a.stop()
        b.stop()
    assert _lane_entries() <= before


def test_threaded_lane_clients_and_a_crash_leave_no_segment(tnative):
    """W lane clients exchange at once (commits = folds = W·STEPS);
    ``crash()`` unlinks every segment as ``stop()`` does, and a client
    closed after either touches no unmapped page (its pin keeps the
    mapping)."""
    before = _lane_entries()
    zeros = {k: np.zeros_like(v) for k, v in _center().items()}
    ps = tnative.NativeSocketParameterServer(zeros, tr.DownpourMerge(), W)
    ps.initialize()
    ps.start()
    ones = {k: np.ones_like(v) for k, v in zeros.items()}
    clients = [tnative.NativePSClient.connect_shm(ps, i, ring_bytes=RING)
               for i in range(W)]
    errors = []

    def work(i):
        try:
            clients[i].pull()
            for s in range(STEPS):
                clients[i].exchange(i, ones, seq=s + 1)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert ps.num_updates == ps.stats()["commits"] == W * STEPS
        # integer sums: exact in any fold order
        want = {k: np.full_like(v, W * STEPS) for k, v in zeros.items()}
        assert _equal(ps.get_model(), want)
        assert len(_lane_entries() - before) == W
    finally:
        ps.crash()
    assert _lane_entries() <= before
    for c in clients:
        c.close()
    ps.stop()


def test_the_two_packages_lanes_leave_bit_equal_centers(tnative,
                                                        monkeypatch):
    """The same seeded pulls, commits and exchanges through the JAX native
    server's shm lane and through the port's: bit-equal replies and
    centers (both lanes are the same C++ fold). Skipped only where the JAX
    side cannot build its core, as ``tests/test_shm.py`` skips."""
    from distkeras_tpu import shm as jshm
    from distkeras_tpu.native import load_dkps as jload

    if jload(required=False) is None:
        pytest.skip("no C++ toolchain for the JAX package's core")
    from distkeras_tpu import native_ps as jnative

    mint = jshm.mint_segment
    monkeypatch.setattr(
        jshm, "mint_segment",
        lambda prefix, ring_bytes: mint(f"{shm.SEGMENT_PREFIX}_native_jax",
                                        ring_bytes))
    before = _lane_entries()
    deltas = [_deltas(20 + i, STEPS) for i in range(W)]
    j = _server(jnative, jr.DynSGDMerge(), W)
    t = _server(tnative, tr.DynSGDMerge(), W)
    try:
        jc = [jnative.NativePSClient.connect_shm(j, i, ring_bytes=RING)
              for i in range(W)]
        tc = [tnative.NativePSClient.connect_shm(t, i, ring_bytes=RING)
              for i in range(W)]
        assert len(_lane_entries() - before) == 2 * W
        rj, rt = _drive(jc, deltas), _drive(tc, deltas)
        assert all(_equal(x, y) for x, y in zip(rj, rt))
        assert _equal(j.get_model(), t.get_model())
        assert j.num_updates == t.num_updates == W * STEPS
        for c in jc + tc:
            c.close()
    finally:
        j.stop()
        t.stop()
    assert _lane_entries() <= before
