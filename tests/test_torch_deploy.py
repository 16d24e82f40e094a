"""Live deployment in the port (``distkeras_tpu_torch/deploy``, the PS's
``deploy_report`` and ``mark_epoch``, the serving server's
``deploy_activate`` / ``deploy_status``), held against the JAX package's
``distkeras_tpu/deploy`` case by case (``tests/test_deploy.py``), on the
same inputs, the watchtower's deploy-lag rule and the metrics gauges
included.

- The epoch record, the deploy-lag counters, the snapshot store and the
  rollout policy are host code in both packages: the port's answers equal
  the JAX package's exactly (the record's bytes, the counters, the stored
  versions, the policy's journal).
- The streamer's snapshots are bit-identical to the PS center at their
  version, and the JAX streamer on a JAX PS fed the same commits cuts the
  same versions with the same bits; the chained streamer publishes the
  same bits; the sharded cut equals the group's joined center.
- Serving: a replica hard-killed with a refill swap staged loses no
  routed request (each stream equals the greedy oracle of one version
  whole) and leaks no KV block; the canary → promote → rollback rollout
  runs over two directory-registered replicas with ``health`` read off a
  watchdog (``watchtower_health``) whose ``ServingSLORule`` fires on an
  injected latency fault, and an injected clock (``ctrl.step(now)``),
  every stream equal to the
  oracle of its replica's version, the deploy lag bounded and every
  transition journaled. The oracle is the port's dense ``generate`` at
  the snapshot's weights, which equals the JAX package's ``generate`` at
  the same weights (checked on the first version). No gate reads a wall
  clock: waits poll with deadlines far above their need, and every
  server stops in a ``finally``.
- The trainer knob: an elastic ADAG run with ``deploy_streamer=`` cuts
  one snapshot an epoch and writes the elastic epoch checkpoint.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import deploy as jdeploy
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.parallel import merge_rules as jrules
from distkeras_tpu.resilience import wal as jwal
from distkeras_tpu.sharding.group import aggregate_ps_stats as jaggregate
from distkeras_tpu_torch import deploy as tdeploy
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.parallel import merge_rules as trules
from distkeras_tpu_torch.resilience import wal as twal
from distkeras_tpu_torch.sharding.group import aggregate_ps_stats

VOCAB, MAXLEN = 64, 64
CFG = dict(vocab=VOCAB, maxlen=MAXLEN, dim=32, heads=4, depth=2)


def _drain_to(streamer, version, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if streamer.stats()["latest_version"] >= version:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"streamer never reached v{version}: {streamer.stats()}")


# -- the epoch record -----------------------------------------------------------

def test_rec_epoch_roundtrip_and_replay():
    blob = twal.encode_record(twal.REC_EPOCH, (3,))
    assert blob == jwal.encode_record(jwal.REC_EPOCH, (3,))
    assert list(twal.iter_records(blob)) == [(twal.REC_EPOCH, (3,))]
    assert twal._REC_NAMES[twal.REC_EPOCH] == "epoch"
    for wal, rule in ((twal, trules.DownpourMerge()),
                      (jwal, jrules.DownpourMerge())):
        state = {"center": {"w": np.zeros(2, np.float32)}, "num_updates": 5,
                 "pull_versions": {}, "prev_pull_versions": {},
                 "last_seq": {}}
        wal.replay_record(state, wal.REC_EPOCH, (2,), rule, 1, None)
        assert state["epoch_mark"] == 2 and state["num_updates"] == 5
        wal.replay_record(state, wal.REC_EPOCH, (1,), rule, 1, None)
        assert state["epoch_mark"] == 2   # monotone


def test_ps_mark_epoch_logs_only_when_observable(tmp_path):
    """No log and no replica: the mark is skipped; with a WAL it lands in
    the log (the same bytes in both packages) and recovery restores it."""
    tps.ParameterServer({"w": np.zeros(2, np.float32)},
                        trules.DownpourMerge(), 1).mark_epoch(0)
    logs = {}
    for name, mod, wal, rule in (
            ("port", tps, twal, trules.DownpourMerge()),
            ("jax", jps, jwal, jrules.DownpourMerge())):
        d = tmp_path / name
        ps = mod.ParameterServer({"w": np.zeros(2, np.float32)}, rule, 1,
                                 wal_dir=str(d))
        ps.pull(0)
        ps.commit(0, {"w": np.ones(2, np.float32)})
        ps.mark_epoch(4)
        ps.stop()
        state = wal.recover_ps_state(str(d), rule, 1, None,
                                     template={"w": np.zeros(2, np.float32)})
        assert state["epoch_mark"] == 4 and state["num_updates"] == 1
        logs[name] = b"".join(p.read_bytes() for p in sorted(d.glob("*.log")))
    assert logs["port"] == logs["jax"] and logs["port"]


# -- deploy-lag accounting ------------------------------------------------------

def test_deploy_lag_stats_and_sharded_rollup():
    got = []
    for mod, rule in ((tps, trules.DownpourMerge()),
                      (jps, jrules.DownpourMerge())):
        ps = mod.ParameterServer({"w": np.zeros(2, np.float32)}, rule, 1)
        for _ in range(3):
            ps.pull(0)
            ps.commit(0, {"w": np.ones(2, np.float32)})
        s = ps.stats()
        assert s["deploy_version"] == 0 and s["deploy_lag_folds"] == 0
        ps.report_deploy_version(2)
        ps.report_deploy_version(1)   # monotone
        s = ps.stats()
        got.append((s["deploy_version"], s["deploy_lag_folds"]))
    assert got == [(2, 1), (2, 1)]
    per = [{"num_updates": 10, "deploy_version": 8, "deploy_lag_folds": 2,
            "commits": 10},
           {"num_updates": 10, "deploy_version": 4, "deploy_lag_folds": 6,
            "commits": 10}]
    agg, jagg = aggregate_ps_stats(per), jaggregate(per)
    assert (agg["deploy_version"], agg["deploy_lag_folds"]) == \
        (jagg["deploy_version"], jagg["deploy_lag_folds"]) == (4, 6)


def test_deploy_report_over_the_wire_and_the_sharded_fan_out():
    from distkeras_tpu_torch.sharding.group import ShardedPSGroup

    ps = tps.SocketParameterServer({"w": np.zeros(2, np.float32)},
                                   trules.ADAGMerge(), 1)
    ps.initialize()
    ps.start()
    try:
        c = tps.ParameterServerClient("127.0.0.1", ps.port, 0)
        c.pull()
        c.commit(0, {"w": np.ones(2, np.float32)})
        c.report_deploy_version(1)
        c.close()
        s = ps.stats()
        assert (s["deploy_version"], s["deploy_lag_folds"]) == (1, 0)
    finally:
        ps.stop()
    group = ShardedPSGroup({"a": np.zeros(4, np.float32),
                            "b": np.zeros(3, np.float32)},
                           trules.DownpourMerge(), 1, num_shards=2,
                           transport="inprocess")
    group.initialize()
    group.start()
    try:
        group.report_deploy_version(0)
        c = group.make_client(0)
        c.pull()
        c.commit(0, {"a": np.ones(4, np.float32),
                     "b": np.ones(3, np.float32)})
        group.report_deploy_version(1)
        s = group.stats()
        assert s["deploy_version"] == 1 and s["deploy_lag_folds"] == 0
    finally:
        group.stop()


# -- the snapshot store ------------------------------------------------------------

@pytest.mark.parametrize("pkg", [tdeploy, jdeploy])
def test_snapshot_store_monotone_prune_subscribe(pkg):
    store = pkg.SnapshotStore(keep=2)
    seen = []
    store.subscribe(lambda s: seen.append(s.version))
    t = {"w": np.ones(2, np.float32)}
    assert store.publish(10, t)
    assert not store.publish(10, t)
    assert not store.publish(5, t)
    assert store.publish(20, t) and store.publish(30, t)
    assert store.versions() == [20, 30]
    assert store.latest().version == 30 and store.get(20) is not None
    assert seen == [10, 20, 30]
    with pytest.raises(ValueError, match="keep"):
        pkg.SnapshotStore(keep=0)


def test_epoch_snapshot_writes_elastic_checkpoint(tmp_path):
    from distkeras_tpu.checkpoint import restore_checkpoint as jrestore
    from distkeras_tpu_torch.checkpoint import restore_checkpoint

    tree = {"w": np.arange(4, dtype=np.float32)}
    payloads = []
    for pkg, restore, d in ((tdeploy, restore_checkpoint, tmp_path / "t"),
                            (jdeploy, jrestore, tmp_path / "j")):
        store = pkg.SnapshotStore(keep=4, checkpoint_dir=str(d))
        store.publish(10, tree, epoch=None)   # a fold cut: no checkpoint
        assert store.checkpoints_written == 0
        store.publish(25, tree, epoch=3)      # an epoch cut: checkpointed
        assert store.checkpoints_written == 1
        payload, step = restore(str(d))
        assert step == 25
        payloads.append(payload)
    got, want = payloads
    assert set(got) == set(want)
    assert got["workers"] == want["workers"] == []
    assert (got["epoch"], got["num_updates"]) == \
        (want["epoch"], want["num_updates"]) == (3, 25)
    np.testing.assert_array_equal(got["center"]["w"], want["center"]["w"])


# -- weight streaming -------------------------------------------------------------

def test_streamer_cuts_at_folds_and_epochs_bit_identical():
    """Fold cuts at multiples of ``snapshot_every``, an epoch mark cuts
    with its epoch, each snapshot the PS center's bits, the version
    reported back into the lag; the JAX streamer on a JAX PS fed the same
    commits publishes the same versions and bits."""
    rng = np.random.default_rng(0)
    deltas = [{"w": rng.normal(size=4).astype(np.float32)}
              for _ in range(12)]
    runs = {}
    for name, mod, pkg, rules in (("port", tps, tdeploy, trules),
                                  ("jax", jps, jdeploy, jrules)):
        ps = mod.ParameterServer({"w": np.zeros(4, np.float32)},
                                 rules.ADAGMerge(), 2)
        st = pkg.WeightStreamer(rules.ADAGMerge(), 2, snapshot_every=5)
        st.attach_to(ps)
        try:
            for d in deltas:
                ps.pull(0)
                ps.commit(0, d)
            ps.mark_epoch(0)
            _drain_to(st, 12)
            assert st.store.versions() == [5, 10, 12]
            assert st.store.get(12).epoch == 0
            assert st.store.get(10).epoch is None
            np.testing.assert_array_equal(st.store.latest().tree["w"],
                                          ps.get_model()["w"])
            s = ps.stats()
            assert s["deploy_version"] == 12 and s["deploy_lag_folds"] == 0
            rep = st.stats()["replicas"][0]
            assert rep["streaming"] and rep["num_updates"] == 12
            runs[name] = {v: st.store.get(v).tree["w"].copy()
                          for v in st.store.versions()}
        finally:
            st.close()
    assert set(runs["port"]) == set(runs["jax"])
    for v in runs["port"]:
        np.testing.assert_array_equal(runs["port"][v], runs["jax"][v])


def test_streamer_chain_shares_one_replica_slot():
    ps = tps.ParameterServer({"w": np.zeros(4, np.float32)},
                             trules.ADAGMerge(), 2)
    s1 = tdeploy.WeightStreamer(trules.ADAGMerge(), 2, snapshot_every=4)
    s2 = tdeploy.WeightStreamer(trules.ADAGMerge(), 2, snapshot_every=4)
    s1.chain_to(s2)
    s1.attach_to(ps)
    other = tdeploy.WeightStreamer(trules.ADAGMerge(), 2)
    try:
        with pytest.raises(ValueError, match="slot is taken"):
            other.attach_to(ps)
        d = {"w": np.ones(4, np.float32)}
        for _ in range(8):
            ps.pull(1)
            ps.commit(1, d)
        _drain_to(s1, 8)
        _drain_to(s2, 8)
        np.testing.assert_array_equal(s1.store.latest().tree["w"],
                                      s2.store.latest().tree["w"])
        assert s2.store.versions() == [4, 8]
    finally:
        s1.close()
        s2.close()
        other.close()


def test_streamer_sharded_consistent_cut():
    from distkeras_tpu_torch.sharding.group import ShardedPSGroup

    tree = {"a": np.zeros(6, np.float32), "b": np.zeros((3, 2), np.float32)}
    group = ShardedPSGroup(tree, trules.DownpourMerge(), 1, num_shards=2,
                           transport="inprocess")
    group.initialize()
    group.start()
    st = tdeploy.WeightStreamer(trules.DownpourMerge(), 1, plan=group.plan,
                                snapshot_every=3)
    st.attach_to(group)
    try:
        c = group.make_client(0)
        d = {"a": np.full(6, 0.25, np.float32),
             "b": np.full((3, 2), -0.5, np.float32)}
        for _ in range(6):
            c.pull()
            c.commit(0, d)
        _drain_to(st, 6)
        assert st.store.versions() == [3, 6]
        snap = st.store.latest()
        center = group.get_model()
        for k in tree:
            np.testing.assert_array_equal(snap.tree[k], center[k])
        s = group.stats()
        assert s["deploy_version"] == 6 and s["deploy_lag_folds"] == 0
    finally:
        st.close()
        group.stop()


# -- the rollout policy ------------------------------------------------------------

_CANARY_PROMOTE = [(0.0, None, True, False), (1.0, 4, True, False),
                   (2.0, 4, True, False), (3.5, 4, True, False),
                   (4.0, 4, True, False), (20.0, 4, True, False)]
_ROLLBACK = [(0.0, 2, True, False), (1.0, 2, False, True),
             (2.0, 2, False, True), (3.0, 2, True, False),
             (13.0, 2, True, False), (14.0, 2, False, False)]
_RAMP = [(0.0, 3, True, False), (1.0, 3, True, False),
         (2.0, 3, True, False), (3.0, 3, True, False),
         (4.0, 3, True, False), (5.0, 3, True, False)]


@pytest.mark.parametrize("kw,seq", [
    (dict(canary_fraction=0.5, bake_s=2.0, green_checks=2, red_checks=1,
          cooldown_s=5.0), _CANARY_PROMOTE),
    (dict(canary_fraction=0.25, bake_s=0.0, green_checks=1, red_checks=2,
          cooldown_s=10.0), _ROLLBACK),
    (dict(fractions=[0.1, 0.5], bake_s=0.5, green_checks=1),
     _RAMP)], ids=["promote", "rollback", "ramp"])
def test_rollout_policy_journal_equals_the_jax_policy(kw, seq):
    pol, jpol = tdeploy.RolloutPolicy(**kw), jdeploy.RolloutPolicy(**kw)
    for obs in seq:
        assert pol.observe(*obs) == jpol.observe(*obs)
        assert (pol.state, pol.version, pol.candidate) == \
            (jpol.state, jpol.version, jpol.candidate)
    assert pol.decisions == jpol.decisions and pol.decisions


def test_rollout_policy_canary_bake_promote():
    pol = tdeploy.RolloutPolicy(canary_fraction=0.5, bake_s=2.0,
                                green_checks=2, red_checks=1, cooldown_s=5.0)
    assert pol.observe(0.0, None, True, False) == []
    assert pol.observe(1.0, 4, True, False) == [
        {"t": 1.0, "action": "canary", "state": "canary", "version": 4,
         "fraction": 0.5}]
    assert pol.observe(2.0, 4, True, False) == []
    assert pol.observe(3.5, 4, True, False) == []
    acts = pol.observe(4.0, 4, True, False)
    assert acts[0]["action"] == "promote" and acts[0]["version"] == 4
    assert pol.state == "idle" and pol.version == 4
    assert pol.observe(20.0, 4, True, False) == []


def test_rollout_policy_validates():
    for kw in ({"canary_fraction": 0.0}, {"canary_fraction": 1.5},
               {"bake_s": -1}, {"green_checks": 0}, {"red_checks": 0},
               {"cooldown_s": -0.1}, {"fractions": [0.5, 0.2]}):
        for pkg in (tdeploy, jdeploy):
            with pytest.raises(ValueError):
                pkg.RolloutPolicy(**kw)


def test_deploy_lag_rule_and_metrics_gauge():
    """``tests/test_deploy.py:128`` in both packages: the deploy-lag rule
    abstains with no deploy data and fires over its bound, with equal
    transitions; the metrics schema exports both deploy gauges."""
    from distkeras_tpu.observability import metrics as jm
    from distkeras_tpu.observability import timeseries as jts
    from distkeras_tpu.observability import watch as jw
    from distkeras_tpu_torch.observability import metrics as tm
    from distkeras_tpu_torch.observability import timeseries as tts
    from distkeras_tpu_torch.observability import watch as tw

    logs = []
    for m, ts, w in ((jm, jts, jw), (tm, tts, tw)):
        keys = [k for k, _, _, _ in m._PS_SCHEMA]
        assert "deploy_lag_folds" in keys and "deploy_version" in keys
        assert any(r.kind == "deploy_lag" for r in w.default_rules())
        store = ts.TimeSeriesStore()
        wd = w.Watchdog(store, rules=[w.DeployLagRule(bound=100.0)])
        wd.evaluate(now=1.0)
        assert not wd.active                   # no data: abstain
        store.sample("ps.deploy_lag_folds", 2.0, 500.0, "gauge")
        wd.evaluate(now=2.0)
        assert not wd.active                   # lag, no deploy version yet
        store.sample("ps.deploy_version", 3.0, 7.0, "gauge")
        wd.evaluate(now=3.0)
        assert any(a["kind"] == "deploy_lag" for a in wd.active.values())
        store.sample("ps.deploy_lag_folds", 4.0, 10.0, "gauge")
        wd.evaluate(now=4.0)
        assert not wd.active                   # caught up: resolves
        logs.append(wd.alerts_json())
    assert logs[1] == logs[0]


def test_watchtower_health_adapter():
    class FakeDog:
        active = {}

    class Tower:
        watchdog = FakeDog

    for alerts, want in (({}, (True, False)),
                         ({"r1": {"kind": "loss_stall"}}, (False, False)),
                         ({"r1": {"kind": "serving_slo"}}, (False, True))):
        FakeDog.active = alerts
        assert tdeploy.watchtower_health(FakeDog()) == want
        assert tdeploy.watchtower_health(Tower()) == want
        assert jdeploy.watchtower_health(FakeDog()) == want


# -- serving ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """A tiny float LM and two weight sets by the port's names."""
    from distkeras_tpu_torch.models.lm import TransformerLM

    out = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        m = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
        out.append({k: v.detach().numpy().copy()
                    for k, v in m.state_dict().items()})
    return out


def _model(tree):
    from distkeras_tpu_torch.models.lm import TransformerLM

    m = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    with torch.no_grad():
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in tree.items()})
    return m


_ORACLES = {}


def _oracle(tree, prompt, n):
    """The greedy dense-cache stream of ``prompt`` at the weights
    ``tree``."""
    from distkeras_tpu_torch.models.lm import generate

    key = (id(tree), tuple(prompt.tolist()), n)
    if key not in _ORACLES:
        with torch.no_grad():
            _ORACLES[key] = generate(_model(tree), prompt[None], n)[
                0, len(prompt):]
    return _ORACLES[key]


def test_oracle_equals_the_jax_generate(lm):
    from distkeras_tpu.models import generate as jgenerate
    from distkeras_tpu.models import transformer_lm as jlm
    from distkeras_tpu_torch.convert import params_to_jax

    spec = jlm(dtype=jnp.float32, **CFG)
    p = params_to_jax({k: torch.from_numpy(v) for k, v in lm[0].items()},
                      _model(lm[0]))
    prompt = np.random.default_rng(3).integers(0, VOCAB, (7,)).astype(
        np.int32)
    want = np.asarray(jgenerate(spec, p, prompt[None], 6))[0, 7:]
    np.testing.assert_array_equal(_oracle(lm[0], prompt, 6), want)


def _serve_replica(tree, version, store, seeds, key):
    from distkeras_tpu_torch.serving import GenerationEngine, GenerationServer

    eng = GenerationEngine(_model(tree), max_batch=2, block_size=8,
                           model_version=version, device="cpu")
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.snapshots = store
    srv.start()
    srv.register_with(seeds, key=key, ttl=5.0)
    return srv


def _wait_fleet(router, want, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        router.refresh(force=True)
        if router.replica_versions() == want:
            return
        time.sleep(0.1)
    raise AssertionError(
        f"fleet never advertised {want}: {router.replica_versions()}")


def test_deploy_actions_and_wait_for_swap(lm):
    """``deploy_activate`` stages a stored version (a miss names the
    stored ones), ``wait_for_swap`` returns once it landed, and
    ``deploy_status`` reports it."""
    from distkeras_tpu_torch.serving import GenerationClient

    store = tdeploy.SnapshotStore(keep=4)
    store.publish(1, lm[0])
    store.publish(2, lm[1])
    from distkeras_tpu_torch.serving import GenerationEngine, GenerationServer

    eng = GenerationEngine(_model(lm[0]), max_batch=2, block_size=8,
                           model_version=1, device="cpu")
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.snapshots = store
    srv.start()
    c = GenerationClient(srv.host, srv.port)
    try:
        miss = c.deploy_activate(9)
        assert not miss["ok"] and miss["versions"] == [1, 2]
        assert c.deploy_activate(2, policy="refill") == {
            "ok": True, "version": 2, "policy": "refill"}
        st = c.wait_for_swap(timeout=60.0)
        assert st["model_version"] == 2 and st["staged_version"] is None
        assert st["versions"] == [1, 2]
        p = np.arange(5, dtype=np.int32)
        np.testing.assert_array_equal(c.generate(p, max_new_tokens=5),
                                      _oracle(lm[1], p, 5))
    finally:
        c.close()
        srv.stop(drain=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_state_dict_equals_quantize_lm(lm, dtype):
    """An int8 replica's swap weights (the float snapshot quantized
    tensor by tensor) are bit-equal to ``quantize_lm`` of a float model
    loaded from the snapshot, in the model dtype the weights are cast
    to."""
    from distkeras_tpu_torch.models.lm import (
        TransformerLM,
        quantize_lm,
        quantize_state_dict,
    )

    full = TransformerLM(dtype=dtype, device="cpu", **CFG)
    with torch.no_grad():
        full.load_state_dict({k: torch.from_numpy(v)
                              for k, v in lm[1].items()})
    want = quantize_lm(full).state_dict()
    qmodel = TransformerLM(dtype=dtype, device="cpu", quant=True, **CFG)
    got = quantize_state_dict(qmodel, lm[1])
    assert set(got) == set(want)
    with torch.no_grad():
        qmodel.load_state_dict(got)
    for k, v in qmodel.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="int8 model"):
        quantize_state_dict(full, lm[1])


def test_int8_replica_activates_the_quantized_snapshot(lm):
    """``deploy_activate`` on an int8 replica swaps in the snapshot
    quantized: the replica then streams what ``quantize_lm`` of the
    snapshot's float model streams."""
    from distkeras_tpu_torch.models.lm import generate, quantize_lm
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    store = tdeploy.SnapshotStore(keep=4)
    store.publish(2, lm[1])
    eng = GenerationEngine(quantize_lm(_model(lm[0])), max_batch=2,
                           block_size=8, model_version=1, device="cpu")
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.snapshots = store
    srv.start()
    c = GenerationClient(srv.host, srv.port)
    try:
        assert c.deploy_activate(2)["ok"]
        assert c.wait_for_swap(timeout=60.0)["model_version"] == 2
        p = np.arange(5, dtype=np.int32)
        with torch.no_grad():
            want = generate(quantize_lm(_model(lm[1])), p[None], 5)[0, 5:]
        np.testing.assert_array_equal(c.generate(p, max_new_tokens=5),
                                      want)
    finally:
        c.close()
        srv.stop(drain=False)


def test_chaos_hard_kill_replica_mid_swap(lm):
    from distkeras_tpu_torch.directory import DirectoryServer
    from distkeras_tpu_torch.directory.router import RoutedGenerationClient
    from distkeras_tpu_torch.serving import GenerationClient

    store = tdeploy.SnapshotStore(keep=4)
    store.publish(1, lm[0])
    store.publish(2, lm[1])
    dsrv = DirectoryServer(default_ttl=2.0)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    srv_a = srv_b = router = None
    try:
        srv_a = _serve_replica(lm[0], 1, store, seeds, "rep-a")
        srv_b = _serve_replica(lm[0], 1, store, seeds, "rep-b")
        router = RoutedGenerationClient(directory=seeds,
                                        refresh_interval=0.2)
        rng = np.random.default_rng(17)
        prompts = [rng.integers(0, VOCAB, (6 + i,)).astype(np.int32)
                   for i in range(6)]
        results, errs = {}, []

        def client(i):
            try:
                results[i] = router.generate(prompts[i], max_new_tokens=10)
            except Exception as e:  # noqa: BLE001 — asserted empty
                errs.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        c = GenerationClient(srv_a.host, srv_a.port)
        c.deploy_activate(2, policy="refill")
        c.close()
        srv_a.stop(drain=False, timeout=5.0)
        for t in threads:
            t.join(120)
        assert not errs, errs
        assert len(results) == 6
        for i, toks in results.items():
            o1, o2 = (_oracle(lm[0], prompts[i], 10),
                      _oracle(lm[1], prompts[i], 10))
            assert np.array_equal(toks, o1) or np.array_equal(toks, o2)
        va = srv_a.engine.stats()
        assert va["blocks_in_use"] == 0 and va["active"] == 0
        assert srv_b.engine.stats()["blocks_in_use"] == 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            router.refresh(force=True)
            if set(router.replicas) == {"rep-b"}:
                break
            time.sleep(0.2)
        assert set(router.replicas) == {"rep-b"}
    finally:
        if router is not None:
            router.close()
        for srv in (srv_b, srv_a):
            if srv is not None:
                srv.stop(drain=False)
        dsrv.stop()


def test_e2e_stream_canary_promote_then_rollback(lm):
    """Two workers fold live into an ADAG PS while a streamer cuts
    versions; two directory-registered replicas serve; a canary of the
    next version is promoted while the watchdog stays green, a third is
    rolled back when an injected latency fault fires its
    ``ServingSLORule`` (``health`` is ``watchtower_health`` of the
    watchdog, as in the JAX package's acceptance test). The controller
    and the watchdog run on an injected clock."""
    from distkeras_tpu_torch.directory import DirectoryServer
    from distkeras_tpu_torch.directory.router import RoutedGenerationClient
    from distkeras_tpu_torch.observability.timeseries import TimeSeriesStore
    from distkeras_tpu_torch.observability.watch import (
        ServingSLORule,
        SLOClass,
        Watchdog,
    )
    from distkeras_tpu_torch.serving import GenerationClient

    ps = tps.ParameterServer(lm[0], trules.ADAGMerge(), 2)
    st = tdeploy.WeightStreamer(trules.ADAGMerge(), 2, snapshot_every=4)
    st.attach_to(ps)

    def train(folds):
        def worker(wid, n):
            rng = np.random.default_rng(wid)
            for _ in range(n):
                center = ps.pull(wid)
                ps.commit(wid, {k: (rng.standard_normal(a.shape) * 1e-3
                                    ).astype(a.dtype)
                                for k, a in center.items()})

        ts = [threading.Thread(target=worker, args=(w, folds // 2))
              for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)

    dsrv = DirectoryServer(default_ttl=3.0)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    router = None
    servers = []
    try:
        train(8)
        _drain_to(st, 8)
        va = st.store.versions()[0]
        base = st.store.get(va)
        servers = [_serve_replica(base.tree, va, st.store, seeds, f"rep-{i}")
                   for i in range(2)]
        router = RoutedGenerationClient(directory=seeds,
                                        refresh_interval=0.2)
        _wait_fleet(router, {"rep-0": va, "rep-1": va})
        by_key = {f"rep-{i}": srv for i, srv in enumerate(servers)}
        # the serving SLO is the rollback trigger; feeding its series by
        # hand makes green and red deterministic
        tstore = TimeSeriesStore()
        wd = Watchdog(tstore, rules=[
            ServingSLORule(slo={"default": SLOClass(p99_ms=500.0)})])

        def observe(p99_ms, now):
            tstore.sample("serve.lat.default.p99_ms", now, p99_ms)
            wd.evaluate(now=now)

        def activate(key, version):
            c = GenerationClient(by_key[key].host, by_key[key].port)
            try:
                ok = bool(c.deploy_activate(version, policy="refill")["ok"])
                c.wait_for_swap(timeout=60.0)
                return ok
            finally:
                c.close()

        ctrl = tdeploy.RolloutController(
            router, activate, lambda: tdeploy.watchtower_health(wd),
            policy=tdeploy.RolloutPolicy(canary_fraction=0.5, bake_s=0.0,
                                         green_checks=1, red_checks=1,
                                         cooldown_s=0.0))

        def served_bit_identical():
            rng = np.random.default_rng(5)
            for key, srv in by_key.items():
                c = GenerationClient(srv.host, srv.port)
                try:
                    v = c.deploy_status()["model_version"]
                    p = rng.integers(0, VOCAB, (8,)).astype(np.int32)
                    toks = c.generate(p, max_new_tokens=8)
                finally:
                    c.close()
                np.testing.assert_array_equal(
                    toks, _oracle(st.store.get(v).tree, p, 8),
                    err_msg=f"{key} tore the stream at v{v}")

        train(8)
        _drain_to(st, 16)
        vb = st.store.versions()[-1]
        assert vb > va
        ctrl.begin(vb)
        observe(50.0, 1.0)                        # healthy latency: green
        assert [a["action"] for a in ctrl.step(1.0)] == ["canary"]
        assert len(ctrl.canary_keys) == 1
        canary, = ctrl.canary_keys
        rest, = set(by_key) - {canary}
        _wait_fleet(router, {canary: vb, rest: va})
        served_bit_identical()
        observe(60.0, 2.0)
        assert [a["action"] for a in ctrl.step(2.0)] == ["promote"]
        _wait_fleet(router, {"rep-0": vb, "rep-1": vb})
        served_bit_identical()

        train(8)
        _drain_to(st, 24)
        vc = st.store.versions()[-1]
        assert vc > vb
        ctrl.begin(vc)
        observe(55.0, 3.0)
        assert [a["action"] for a in ctrl.step(3.0)] == ["canary"]
        observe(5000.0, 4.0)                      # the injected fault
        assert tdeploy.watchtower_health(wd) == (False, True)
        assert [a["action"] for a in ctrl.step(4.0)] == ["rollback"]
        _wait_fleet(router, {"rep-0": vb, "rep-1": vb})
        served_bit_identical()

        rng = np.random.default_rng(23)
        for _ in range(4):
            p = rng.integers(0, VOCAB, (7,)).astype(np.int32)
            np.testing.assert_array_equal(
                router.generate(p, max_new_tokens=6),
                _oracle(st.store.get(vb).tree, p, 6))
        rs = router.stats()
        assert rs["routed_by_version"].get(vb, 0) >= 4
        assert set(rs["replica_versions"].values()) == {vb}
        assert [j["action"] for j in ctrl.journal] == [
            "canary", "promote", "canary", "rollback"]
        assert all(j["activated"] == len(j["keys"]) for j in ctrl.journal)
        assert ps.stats()["deploy_lag_folds"] <= st.snapshot_every
    finally:
        if router is not None:
            router.close()
        for srv in servers:
            srv.stop(drain=False)
        st.close()
        dsrv.stop()


# -- the trainer knob ----------------------------------------------------------------

def test_trainer_deploy_streamer_knob_elastic_epoch_checkpoint(tmp_path):
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.checkpoint import (
        restore_checkpoint,
        warn_elastic_resume,
    )
    from tests.test_torch_ps import _spec, blobs

    st = tdeploy.WeightStreamer(trules.ADAGMerge(), 2, snapshot_every=0,
                                checkpoint_dir=str(tmp_path / "deploy-ckpt"))
    t = trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", learning_rate=0.05,
                      num_workers=2, batch_size=16, communication_window=2,
                      num_epoch=2, backend="ps", elastic=True,
                      deploy_streamer=st, device="cpu")
    try:
        t.train(blobs(n=512))
        _drain_to(st, 1)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline \
                and st.store.checkpoints_written < 2:
            time.sleep(0.05)
        assert st.store.checkpoints_written == 2
        snaps = [st.store.get(v) for v in st.store.versions()]
        assert all(s.epoch in (0, 1) for s in snaps)
        assert snaps[-1].epoch == 1
        payload, step = restore_checkpoint(str(tmp_path / "deploy-ckpt"))
        assert payload["workers"] == [] and payload["epoch"] == 1
        assert payload["num_updates"] == step == st.store.latest().version
        with pytest.warns(UserWarning, match="elastic resume"):
            warn_elastic_resume(len(payload["workers"]), 2)
    finally:
        st.close()
    with pytest.raises(ValueError, match="deploy_streamer"):
        trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      num_workers=2, backend="ps", ps_transport="socket",
                      ps_host="10.0.0.1", deploy_streamer=object(),
                      device="cpu")
