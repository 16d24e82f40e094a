"""The port's Polyak average of the center (``ema_decay``) held against the
JAX package on the CPU: the collective backend's window fold
(``trainers._ema_tracking``), the parameter servers' per-commit fold on
every transport, its WAL replay, its replication to a standby and down a
chain, and the sharded center's join.

Tolerances, each with its reason:

- the Python servers of the two packages are host numpy running the same
  ops in the same order: EMAs bit for bit (tolerance 0), live, replayed
  from a WAL, promoted from a standby, and joined over shards;
- the native server folds ``d·e + (1−d)·c`` in f32 with ``1 − d`` rounded
  in f32, where numpy rounds the f64 ``1 − d`` to f32: within rtol 1e-6
  and atol 1e-7 of the Python server (the JAX package's own bound,
  ``tests/test_native_ps.py``); its WAL replays the C++ arithmetic, so a
  replayed native EMA is the live one bit for bit;
- the collective backend against the JAX trainer from the same initial
  weights: within 1e-5 absolute in f32 (the centers' bound in
  ``tests/test_torch_trainers.py``); ``ema_decay=0`` gives the center
  itself, bit for bit.
"""

import copy
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.resilience import wal as jwal
from distkeras_tpu_torch import checkpoint as ckpt
from distkeras_tpu_torch import native, trainers, utils
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.resilience import wal as twal
from distkeras_tpu_torch.sharding import ShardedPSGroup

_PKG = {"port": (tps, tr, twal), "jax": (jps, jr, jwal)}


@pytest.fixture(scope="module")
def tnative():
    native.load_dkps()   # builds libdkps; a failure fails the test
    from distkeras_tpu_torch import native_ps

    return native_ps


def _tree():
    rng = np.random.default_rng(1)
    return {"dense": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                      "bias": np.zeros(5, np.float32)},
            "emb": rng.normal(size=(40, 8)).astype(np.float32),
            "wh": rng.normal(size=(3,)).astype(np.float32)}


def _delta(rng, tree):
    return utils.host_tree_map(
        lambda x: (0.1 * rng.standard_normal(np.shape(x))).astype(
            np.float32), tree)


def _events(n=17, workers=3, seed=0):
    """Scripted (worker, pull first?, commit) events: irregular pulls, so
    DynSGD prices different staleness commit to commit."""
    rng = np.random.default_rng(seed)
    tree = _tree()
    return [(k % workers, k % 4 != 2, _delta(rng, tree)) for k in range(n)]


def _drive(ps, events):
    for w, do_pull, payload in events:
        if do_pull:
            ps.pull(w)
        ps.commit(w, payload)


def _assert_bits(a, b):
    la, lb = utils.flatten(a)[0], utils.flatten(b)[0]
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _blobs(n=512):
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 3.0, size=(4, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1.0, size=(n, 16)).astype(np.float32)
    return x, y


def _spec():
    return torch_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                     dtype=torch.float32)


_KW = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
           learning_rate=0.1, num_workers=4, batch_size=16,
           communication_window=2, device="cpu")


# -- the Python servers ----------------------------------------------------------


def test_ps_ema_fold_matches_hand_computed():
    """e = d·e + (1−d)·c after each fold, from e = the initial center."""
    d = 0.5
    ps = tps.ParameterServer({"w": np.zeros(3, np.float32)},
                             tr.DownpourMerge(), num_workers=1, ema_decay=d)
    ema = np.zeros(3, np.float32)
    center = np.zeros(3, np.float32)
    rng = np.random.default_rng(0)
    for _ in range(5):
        delta = rng.normal(size=3).astype(np.float32)
        ps.commit(0, {"w": delta})
        center = center + delta
        ema = d * ema + (1 - d) * center
        np.testing.assert_allclose(ps.get_ema()["w"], ema, rtol=1e-6)
    np.testing.assert_allclose(ps.get_model()["w"], center, rtol=1e-6)
    assert tps.ParameterServer({"w": np.zeros(1)}, tr.ADAGMerge(),
                               1).get_ema() is None


@pytest.mark.parametrize("rule", ["DynSGDMerge", "ADAGMerge",
                                  "DownpourMerge"])
@pytest.mark.parametrize("decay", [0.0, 0.9, 0.97])
def test_python_ps_ema_bit_identical_to_jax_ps(rule, decay):
    """The same commit sequence through both packages' Python servers:
    the EMAs (and centers) equal bit for bit."""
    evs = _events()
    out = {}
    for pkg, (ps_mod, rules, _) in _PKG.items():
        ps = ps_mod.ParameterServer(_tree(), getattr(rules, rule)(), 3,
                                    ema_decay=decay)
        _drive(ps, evs)
        out[pkg] = ps
    _assert_bits(out["port"].get_ema(), out["jax"].get_ema())
    _assert_bits(out["port"].get_model(), out["jax"].get_model())
    if decay == 0.0:
        _assert_bits(out["port"].get_ema(), out["port"].get_model())


def test_ps_ema_validation():
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="ema_decay must be"):
            tps.ParameterServer(_tree(), tr.ADAGMerge(), 1, ema_decay=bad)
    with pytest.raises(ValueError, match="ema_decay must be"):
        trainers.ADAG(_spec(), num_workers=2, ema_decay=1.0, device="cpu")
    with pytest.raises(ValueError, match="PS owner"):
        trainers.DOWNPOUR(_spec(), num_workers=2, backend="ps",
                          ps_transport="socket", ps_host="127.0.0.1",
                          ema_decay=0.9, device="cpu")


# -- the WAL ------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_wal_replayed_ema_equals_the_live_one(tmp_path, writer, reader):
    """A durable server's log (snapshots every 5 commits, so replay starts
    from a snapshot's EMA) replays to the live EMA bit for bit, in either
    package, whichever wrote it."""
    ps_mod, rules, _ = _PKG[writer]
    live = ps_mod.ParameterServer(_tree(), rules.DynSGDMerge(), 3,
                                  ema_decay=0.97, wal_dir=str(tmp_path),
                                  snapshot_every=5)
    _drive(live, _events(23))
    live._wal.sync()
    live._wal.abandon()             # a crash: the log as it stands
    _, rrules, rwal = _PKG[reader]
    state = rwal.recover_ps_state(str(tmp_path), rrules.DynSGDMerge(), 3,
                                  0.97, template=_tree())
    assert state["num_updates"] == 23 and state["ema_version"] == 23
    _assert_bits(state["ema"], live.get_ema())
    _assert_bits(state["center"], live.get_model())
    if reader == "port":
        again = tps.ParameterServer(_tree(), tr.DynSGDMerge(), 3,
                                    ema_decay=0.97, wal_dir=str(tmp_path))
        assert again.recovered_
        _assert_bits(again.get_ema(), live.get_ema())
        again.stop()


def test_wal_without_a_snapshot_replays_the_ema_from_the_template(tmp_path):
    live = tps.ParameterServer(_tree(), tr.ADAGMerge(), 3, ema_decay=0.9,
                               wal_dir=str(tmp_path), snapshot_every=1000)
    _drive(live, _events(9))
    live.stop()
    assert not [n for n in __import__("os").listdir(tmp_path)
                if n.startswith("snap-")]
    state = twal.recover_ps_state(str(tmp_path), tr.ADAGMerge(), 3, 0.9,
                                  template=_tree())
    _assert_bits(state["ema"], live.get_ema())


def test_native_wal_replayed_ema_equals_the_live_one(tmp_path, tnative):
    """The C++ core folds the EMA in f32 and logs flat records; replay
    mirrors its arithmetic, so the recovered EMA is the live one bit for
    bit, and a restarted native server serves it."""
    center = {"w": np.arange(600, dtype=np.float32) * 1e-3,
              "b": {"x": np.ones(7, np.float32)}}
    rule = tr.DynSGDMerge()
    rng = np.random.default_rng(3)
    ps = tnative.NativeSocketParameterServer(
        center, rule, 2, wal_dir=str(tmp_path), ema_decay=0.9,
        wal_group_window=4)
    ps.initialize()
    ps.start()
    clients = [tnative.NativePSClient("127.0.0.1", ps.port, i, ps.spec)
               for i in range(2)]
    try:
        for k in range(9):
            w = k % 2
            if k % 3 != 2:
                clients[w].pull()
            clients[w].commit(w, {
                "w": rng.standard_normal(600).astype(np.float32),
                "b": {"x": rng.standard_normal(7).astype(np.float32)}},
                seq=k + 1)
        live_model, live_ema = ps.get_model(), ps.get_ema()
    finally:
        for c in clients:
            c.close()
        ps.stop()
    for pkg in ("port", "jax"):
        _, rules, wal = _PKG[pkg]
        state = wal.recover_ps_state(str(tmp_path), rules.DynSGDMerge(), 2,
                                     0.9, template=center)
        assert state["num_updates"] == 9
        _assert_bits(state["center"], live_model)
        _assert_bits(state["ema"], live_ema)
    ps2 = tnative.NativeSocketParameterServer(center, rule, 2,
                                              wal_dir=str(tmp_path),
                                              ema_decay=0.9)
    ps2.initialize()
    ps2.start()
    try:
        assert ps2.recovered_ and ps2.num_updates == 9
        _assert_bits(ps2.get_ema(), live_ema)
    finally:
        ps2.stop()


# -- the native server ----------------------------------------------------------------


def test_native_ema_matches_python_ps(tnative):
    """The C++ per-commit EMA against the Python server's on the same
    commits (rtol 1e-6, atol 1e-7: see the module docstring)."""
    center = {"w": np.zeros(48, np.float32), "b": np.zeros(5, np.float32)}
    rng = np.random.default_rng(2)
    py = tps.ParameterServer(center, tr.DownpourMerge(), 1, ema_decay=0.7)
    ps = tnative.NativeSocketParameterServer(center, tr.DownpourMerge(), 1,
                                             ema_decay=0.7)
    ps.initialize()
    ps.start()
    try:
        c = tnative.NativePSClient("127.0.0.1", ps.port, 0, ps.spec)
        for _ in range(6):
            delta = {"w": rng.normal(size=48).astype(np.float32),
                     "b": rng.normal(size=5).astype(np.float32)}
            py.pull(0)
            py.commit(0, delta)
            c.pull()
            c.commit(0, delta)
        for a, b in zip(utils.flatten(ps.get_ema())[0],
                        utils.flatten(py.get_ema())[0]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        c.close()
    finally:
        ps.stop()
    off = tnative.NativeSocketParameterServer(center, tr.ADAGMerge(), 1)
    off.initialize()
    try:
        assert off.get_ema() is None
    finally:
        off.stop()


# -- replication: the hot standby and the chain ------------------------------------


def test_standby_promotes_with_the_primary_ema():
    ps = tps.SocketParameterServer(_tree(), tr.DynSGDMerge(), 3,
                                   ema_decay=0.9)
    sb = tps.StandbySocketParameterServer(_tree(), tr.DynSGDMerge(), 3,
                                          ema_decay=0.9)
    for s in (ps, sb):
        s.initialize()
        s.start()
    try:
        _drive(ps, _events(4))      # the EMA is past the template already
        ps.attach_standby("127.0.0.1", sb.port)
        _drive(ps, _events(11, seed=5))
        primary_ema = ps.get_ema()
        sb.promote(epoch=1)
        assert sb.num_updates == 15
        _assert_bits(sb.get_ema(), primary_ema)
        _assert_bits(sb.get_model(), ps.get_model())
    finally:
        ps.stop()
        sb.stop()


def test_a_promoted_chain_link_carries_the_ema():
    """primary → r1 → r2: the tail applies records forwarded by the middle
    link (``replay_record`` with the decay); promoted, it serves the
    primary's EMA bit for bit."""
    servers = [tps.SocketParameterServer(_tree(), tr.ADAGMerge(), 3,
                                         ema_decay=0.8)]
    servers += [tps.StandbySocketParameterServer(_tree(), tr.ADAGMerge(), 3,
                                                 ema_decay=0.8)
                for _ in range(2)]
    for s in servers:
        s.initialize()
        s.start()
    p, r1, r2 = servers
    try:
        r1.attach_standby("127.0.0.1", r2.port)
        p.attach_standby("127.0.0.1", r1.port)
        _drive(p, _events(13))
        r1.promote(epoch=1, drain_timeout=10.0)
        r2.promote(epoch=2, drain_timeout=10.0)
        _assert_bits(r2.get_ema(), p.get_ema())
        _assert_bits(r1.get_ema(), p.get_ema())
    finally:
        for s in servers:
            s.stop()


# -- the sharded center ----------------------------------------------------------------


@pytest.mark.parametrize("transport", ["inprocess", "socket", "shm"])
def test_sharded_ema_equals_the_single_server(transport):
    """Folds are leafwise and every shard sees the global fold order, so
    the join of the shards' EMAs is the single server's, bit for bit."""
    evs = _events()
    single = tps.ParameterServer(_tree(), tr.DynSGDMerge(), 3,
                                 ema_decay=0.95)
    _drive(single, evs)
    group = ShardedPSGroup(copy.deepcopy(_tree()), tr.DynSGDMerge(), 3,
                           num_shards=3, transport=transport,
                           ema_decay=0.95)
    group.initialize()
    group.start()
    clients = [group.make_client(w) for w in range(3)]
    try:
        for w, do_pull, payload in evs:
            if do_pull:
                clients[w].pull()
            clients[w].commit(w, payload)
        _assert_bits(group.get_ema(), single.get_ema())
        _assert_bits(group.get_model(), single.get_model())
    finally:
        for c in clients:
            c.close()
        group.stop()


def test_native_sharded_ema_equals_the_native_single_server(tnative):
    evs = _events(9)
    out = []
    for shards in (1, 3):
        group = ShardedPSGroup(copy.deepcopy(_tree()), tr.DownpourMerge(), 3,
                               num_shards=shards, transport="native",
                               ema_decay=0.9)
        group.initialize()
        group.start()
        clients = [group.make_client(w) for w in range(3)]
        try:
            for w, do_pull, payload in evs:
                if do_pull:
                    clients[w].pull()
                clients[w].commit(w, payload)
            out.append(group.get_ema())
        finally:
            for c in clients:
                c.close()
            group.stop()
    _assert_bits(out[0], out[1])


def test_sharded_group_without_ema_answers_none():
    group = ShardedPSGroup(_tree(), tr.ADAGMerge(), 1, num_shards=2)
    assert group.get_ema() is None


# -- the collective backend ---------------------------------------------------------


def test_collective_ema_decay_zero_equals_center():
    """decay 0 makes the EMA the latest center: pins the fold order (the
    post-merge center each window)."""
    t = trainers.ADAG(_spec(), num_epoch=2, device_data=False, ema_decay=0.0,
                      **_KW)
    params = t.train(Dataset.from_arrays(*_blobs()), shuffle=True)
    assert set(t.ema_params_) == set(params)
    for k in params:
        assert torch.equal(t.ema_params_[k], params[k])


def test_collective_ema_tracks_behind_the_center():
    t = trainers.ADAG(_spec(), num_epoch=2, device_data=False, ema_decay=0.9,
                      **_KW)
    params = t.train(Dataset.from_arrays(*_blobs()), shuffle=True)
    diffs = [(t.ema_params_[k] - params[k]).abs().max().item()
             for k in params]
    assert max(diffs) > 0 and all(np.isfinite(diffs))


def test_ema_forces_streaming_with_warning():
    t = trainers.ADAG(_spec(), num_epoch=1, device_data=True, ema_decay=0.5,
                      **_KW)
    with pytest.warns(UserWarning, match="streaming"):
        t.train(Dataset.from_arrays(*_blobs()))
    assert t.ema_params_ is not None


def test_single_trainer_takes_ema_decay():
    t = trainers.SingleTrainer(_spec(), loss="sparse_softmax_cross_entropy",
                               worker_optimizer="sgd", learning_rate=0.1,
                               batch_size=32, ema_decay=0.0, device="cpu")
    params = t.train(Dataset.from_arrays(*_blobs(256)))
    for k in params:
        assert torch.equal(t.ema_params_[k], params[k])


def test_collective_ema_matches_the_jax_trainer():
    """ADAG with ema_decay=0.9 from the same initial weights on the same
    rows, unshuffled: the port's EMA within 1e-5 of the JAX trainer's."""
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    spec = _spec()
    tp = tensors_from_jax(p, spec.module)
    spec = dataclasses.replace(spec, init=lambda seed: (tp, {}))
    x, y = _blobs()
    from distkeras_tpu import data as jdata

    common = {k: v for k, v in _KW.items() if k != "device"}
    jt = jdk.ADAG(jspec, num_epoch=2, device_data=False, ema_decay=0.9,
                  **common)
    jt.train(jdata.Dataset.from_arrays(x, y))
    tt = trainers.ADAG(spec, num_epoch=2, device_data=False, ema_decay=0.9,
                       **_KW)
    tt.train(Dataset.from_arrays(x, y))
    back = params_to_jax(tt.ema_params_, spec.module)
    for a, b in zip(jax.tree.leaves(jt.ema_params_), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_ema_is_not_checkpointed_and_a_resume_restarts_it(tmp_path):
    """The checkpoint holds the training state only; a resumed run's EMA
    starts from the restored center (at decay 0 it ends as the center)."""
    ds = Dataset.from_arrays(*_blobs())
    trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=tmp_path,
                  ema_decay=0.9, **_KW).train(ds)
    payload, _ = ckpt.restore_checkpoint(tmp_path)
    assert set(payload) == {"state", "epoch"}
    t = trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=tmp_path,
                      resume=True, ema_decay=0.0, **_KW)
    params = t.train(ds)
    for k in params:
        assert torch.equal(t.ema_params_[k], params[k])


# -- the PS backend end to end ---------------------------------------------------------


@pytest.mark.parametrize("transport", ["inprocess", "socket", "shm",
                                       "native"])
def test_ps_backend_ema_end_to_end(transport):
    t = trainers.DOWNPOUR(_spec(), loss="sparse_softmax_cross_entropy",
                          worker_optimizer="sgd", learning_rate=0.02,
                          num_workers=2, batch_size=32,
                          communication_window=2, num_epoch=2, backend="ps",
                          ps_transport=transport, ema_decay=0.9,
                          device="cpu")
    params = t.train(Dataset.from_arrays(*_blobs(1024)), shuffle=True)
    assert set(t.ema_params_) == set(params)
    for k in params:
        assert isinstance(t.ema_params_[k], torch.Tensor)
        assert torch.isfinite(t.ema_params_[k]).all()
    assert max((t.ema_params_[k] - params[k]).abs().max().item()
               for k in params) > 0


def test_ps_backend_ema_matches_the_jax_ps_backend():
    """One worker through the in-process PS, unshuffled, from the same
    initial weights: the EMAs within 1e-5 (the W=1 PS centers' bound in
    tests/test_torch_ps.py)."""
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    spec = _spec()
    tp = tensors_from_jax(p, spec.module)
    spec = dataclasses.replace(spec, init=lambda seed: (tp, {}))
    x, y = _blobs()
    from distkeras_tpu import data as jdata

    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=1, batch_size=16,
              communication_window=2, num_epoch=1, backend="ps",
              ema_decay=0.8)
    jt = jdk.DOWNPOUR(jspec, **kw)
    jt.train(jdata.Dataset.from_arrays(x, y))
    tt = trainers.DOWNPOUR(spec, device="cpu", **kw)
    tt.train(Dataset.from_arrays(x, y))
    back = params_to_jax(tt.ema_params_, spec.module)
    for a, b in zip(jax.tree.leaves(jt.ema_params_), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_ps_backend_ema_survives_a_failover():
    """The standby receives the EMA with its replication base and refolds
    it per streamed commit: after the primary is killed mid-run, the
    trainer reads the promoted server's EMA."""
    from distkeras_tpu_torch.resilience import FaultPlan

    t = trainers.DOWNPOUR(_spec(), loss="sparse_softmax_cross_entropy",
                          worker_optimizer="sgd", learning_rate=0.02,
                          num_workers=2, batch_size=32,
                          communication_window=2, num_epoch=2, backend="ps",
                          ps_transport="socket", ps_standby=True,
                          ps_failover_timeout=0.5, ema_decay=0.9,
                          fault_plan=FaultPlan(kill_ps_after_commits=10),
                          device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = t.train(Dataset.from_arrays(*_blobs(1024)))
    assert t.resilience_stats_["ps_failover"]["failovers"] == 1
    for k in params:
        assert torch.isfinite(t.ema_params_[k]).all()
    assert max((t.ema_params_[k] - params[k]).abs().max().item()
               for k in params) > 0
