"""The port's sharded parameter-server center (``distkeras_tpu_torch/
sharding/``) held against the JAX package's (``distkeras_tpu/sharding/``)
on the CPU: the hash ring, bit-identical N-shard folds, chain replication,
the kill-one-shard chaos, the sharded WAL verify and the stats roll-up,
one port test for each of ``tests/test_sharding.py``'s (its sharded live
join is ``tests/test_torch_elastic.py``'s).

Across packages: leaf paths are ``jax.tree_util.keystr``'s strings in
``tree_flatten_with_path``'s order; ``stable_hash``, ``HashRing.assign``
and ``ShardPlan.digest`` are equal for the same numpy tree; and a client
of either package folding into the other's sharded group over sockets
gives the same center bits as a single PS (tolerance 0 throughout: the
center is host numpy in both packages).

The port's merge rules fold nested dicts of arrays (its models' trees), so
the PS trees here are dicts; the ring and plan tests also walk lists,
tuples and ``None``. Every run is bounded: sockets carry timeouts,
failovers are awaited with a budget, and training runs under a watchdog.
"""

import copy
import json
import subprocess
import sys
import time
import warnings

import jax
import numpy as np
import pytest

from distkeras_tpu import sharding as jsh
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.parameter_servers import (
    ParameterServerClient as JClient,
)
from distkeras_tpu_torch import sharding as tsh
from distkeras_tpu_torch import trainers, utils
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.networking import ShardMapMismatchError
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parallel.compression import Int8Codec, maybe_decode
from distkeras_tpu_torch.parameter_servers import (
    ParameterServer,
    ParameterServerClient,
)
from distkeras_tpu_torch.resilience import FaultPlan
from distkeras_tpu_torch.sharding import (
    HashRing,
    ShardedPSGroup,
    ShardPlan,
    stable_hash,
)
from tests.test_torch_ps import _final_loss, _spec, blobs
from tests.test_torch_resilience import _watchdog


def _tree(seed=0, layers=12, base=100, step=37):
    rng = np.random.default_rng(seed)
    return {f"block_{i:02d}": rng.normal(size=(base + step * i,)
                                         ).astype(np.float32)
            for i in range(layers)}


def _model_tree(seed=0):
    """An embedding-dominated tree with nested dicts and an int leaf (one
    leaf holds most of the bytes)."""
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.normal(size=(3000,)).astype(np.float32),
        "dense": {"w": rng.normal(size=(500,)).astype(np.float32),
                  "b": rng.normal(size=(40,)).astype(np.float32)},
        "head": {"k": rng.normal(size=(100,)).astype(np.float32),
                 "n": np.arange(7, dtype=np.int32)},
    }


def _mixed_tree(seed=0):
    """Every container the plan walks: nested dicts, a list, a tuple, a
    ``None`` subtree, an int leaf."""
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.normal(size=(3000,)).astype(np.float32),
        "dense": {"w": rng.normal(size=(500,)).astype(np.float32),
                  "b": rng.normal(size=(40,)).astype(np.float32),
                  "none": None},
        "head": [rng.normal(size=(100,)).astype(np.float32),
                 (np.arange(7, dtype=np.int32),
                  rng.normal(size=(9,)).astype(np.float32))],
    }


def _full(tree, value):
    return utils.host_tree_map(
        lambda leaf: (np.full(np.shape(leaf), value, np.float32)
                      if np.issubdtype(np.asarray(leaf).dtype, np.floating)
                      else np.zeros_like(leaf)), tree)


def _trees_equal(a, b):
    la, lb = utils.flatten(a)[0], utils.flatten(b)[0]
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _is_codec_leaf(node):
    return isinstance(node, dict) and "__dk_leaf__" in node


# -- leaf paths ----------------------------------------------------------------


@pytest.mark.parametrize("make", [_mixed_tree, _model_tree, _tree],
                         ids=["mixed", "model", "flat"])
def test_flatten_with_paths_matches_jax_keystr(make):
    """``utils.flatten_with_paths`` gives ``keystr``'s strings, character
    for character, in ``tree_flatten_with_path``'s order (sorted keys,
    ``None`` an empty subtree), keeps codec leaves whole, and its
    structure rebuilds the tree."""
    tree = make()
    blob = Int8Codec(min_size=1).encode(tree)["tree"]
    for t in (tree, blob):
        pairs, _ = jax.tree_util.tree_flatten_with_path(
            t, is_leaf=_is_codec_leaf)
        want = [(jax.tree_util.keystr(k), v) for k, v in pairs]
        got, structure = utils.flatten_with_paths(t, is_leaf=_is_codec_leaf)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(a is b for (_, a), (_, b) in zip(got, want))
        rebuilt = utils.unflatten(structure, [v for _, v in got])
        assert jax.tree.structure(rebuilt, is_leaf=_is_codec_leaf) == \
            jax.tree.structure(t, is_leaf=_is_codec_leaf)


# -- the hash ring -------------------------------------------------------------


def test_ring_pinned_hash_and_assignment():
    """The ring is pinned (blake2b, never the salted builtin) to the JAX
    package's constants: same hashes, same digest, same assignment."""
    assert stable_hash("shard:0/vnode:0") == 6170415486835965795
    assert stable_hash("leaf:x") == 11958087293876216794
    tree = {f"block_{i:02d}": np.zeros(100 + 37 * i, np.float32)
            for i in range(12)}
    plan = ShardPlan(tree, 4)
    assert plan.digest == "787e1c9c7d880cfd31a28fc705cddd9e0a8e02b1"
    assert ShardPlan(tree, 4).assignment == plan.assignment
    assert plan.assignment == jsh.ShardPlan(tree, 4).assignment


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("make", [_mixed_tree, _model_tree, _tree],
                         ids=["mixed", "model", "flat"])
def test_plan_equals_the_jax_package(make, n_shards):
    """The same numpy tree gives the same paths, sizes, ring assignment,
    per-shard paths and bytes, and digest in both packages."""
    tree = make()
    t, j = ShardPlan(tree, n_shards), jsh.ShardPlan(tree, n_shards)
    assert t.paths == j.paths and t.sizes == j.sizes
    assert t.assignment == j.assignment
    assert t.shard_paths == j.shard_paths
    assert t.shard_nbytes == j.shard_nbytes
    assert t.digest == j.digest
    assert [t.shard_info(s) for s in range(n_shards)] == \
        [j.shard_info(s) for s in range(n_shards)]
    assert HashRing(n_shards).assign(t.sizes) == \
        jsh.HashRing(n_shards).assign(t.sizes)
    assert [stable_hash(f"leaf:{p}") for p in t.paths] == \
        [jsh.stable_hash(f"leaf:{p}") for p in t.paths]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_byte_weighted_balance(n_shards):
    """Each shard's bytes stay within the bounded-load cap (or one
    oversized leaf), and every shard serves a leaf."""
    tree = _tree(layers=32)
    sizes = {p: int(np.asarray(v).nbytes)
             for p, v in ShardPlan(tree, 1)._leaf_map(tree).items()}
    assign = HashRing(n_shards).assign(sizes, bound=1.25)
    total = sum(sizes.values())
    loads = [0] * n_shards
    for p, sid in assign.items():
        loads[sid] += sizes[p]
    assert max(loads) <= max(1.25 * total / n_shards, max(sizes.values()))
    assert min(loads) > 0


def test_ring_minimal_movement_on_resize():
    """Adding or removing a shard moves a bounded share of the bytes, far
    less than ``hash % N``."""
    tree = _tree(layers=64, base=50, step=11)
    sizes = {p: int(np.asarray(v).nbytes)
             for p, v in ShardPlan(tree, 1)._leaf_map(tree).items()}
    total = sum(sizes.values())
    a4 = HashRing(4).assign(sizes)
    for other_n in (3, 5):
        other = HashRing(other_n).assign(sizes)
        moved = sum(sizes[p] for p in sizes if a4[p] != other[p])
        naive = sum(sizes[p] for p in sizes
                    if stable_hash(p) % 4 != stable_hash(p) % other_n)
        assert moved <= 0.55 * total
        assert moved < naive


def test_ring_rejects_more_shards_than_leaves():
    with pytest.raises(ValueError, match="leaf"):
        ShardPlan({"a": np.zeros(4, np.float32)}, 2)


# -- plan scatter / gather ---------------------------------------------------------


@pytest.mark.parametrize("make", [_mixed_tree, _model_tree],
                         ids=["mixed", "model"])
def test_plan_split_join_roundtrip_raw_and_encoded(make):
    """Raw split → join is the identity; an int8 blob's per-shard sub-blobs
    decode exactly as the whole blob; the parts equal the JAX package's
    split of the same tree; a wrong structure is a typed failure."""
    tree = make()
    plan = ShardPlan(tree, 3)
    parts = plan.split(tree)
    assert len(parts) == 3
    assert _trees_equal(plan.join(parts), tree)
    jparts = jsh.ShardPlan(tree, 3).split(tree)
    assert [sorted(p) for p in parts] == [sorted(p) for p in jparts]
    assert all(_trees_equal(a, b) for a, b in zip(parts, jparts))
    # the codecs encode a None subtree as a leaf (in both packages), so
    # the encoded leg drops it
    tree["dense"].pop("none", None)
    plan = ShardPlan(tree, 3)
    codec = Int8Codec(min_size=1)
    blob = codec.encode(tree)
    joined = plan.join([maybe_decode(p) for p in plan.split(blob)])
    assert _trees_equal(joined, codec.decode(blob))
    with pytest.raises(ValueError, match="structure"):
        plan.split({"wrong": np.zeros(3, np.float32)})


# -- bit-identical N-shard folds -------------------------------------------------


def _fold_script(single, c0, c1, tree):
    """Pulls and commits with real staleness: worker 1 commits against a
    one-update-stale pull (τ = 1)."""
    single.pull(0), c0.pull()
    single.pull(1), c1.pull()
    single.commit(0, _full(tree, 0.1)), c0.commit(0, _full(tree, 0.1))
    single.commit(1, _full(tree, 0.2)), c1.commit(1, _full(tree, 0.2))
    single.pull(0), c0.pull()
    single.commit(0, _full(tree, 0.3)), c0.commit(0, _full(tree, 0.3))


@pytest.mark.parametrize("rule", [tr.ADAGMerge(), tr.DownpourMerge(),
                                  tr.DynSGDMerge()],
                         ids=["adag", "downpour", "dynsgd"])
def test_sharded_folds_bit_identical_to_single_ps(rule):
    """The oracle: the same scripted pulls and commits land on exactly the
    same center bits through a 3-shard group as through one PS, and every
    shard folds every commit."""
    tree = _model_tree()
    single = ParameterServer(copy.deepcopy(tree), rule, 2)
    group = ShardedPSGroup(copy.deepcopy(tree), rule, 2, num_shards=3,
                           transport="inprocess")
    group.initialize()
    group.start()
    c0, c1 = group.make_client(0), group.make_client(1)
    try:
        _fold_script(single, c0, c1, tree)
        assert _trees_equal(single.get_model(), group.get_model())
        s = group.stats()
        assert s["num_updates"] == s["num_updates_max"] == 3
        assert all(p["num_updates"] == 3 for p in s["per_shard"])
    finally:
        c0.close()
        c1.close()
        group.stop()
        single.stop()


def test_sharded_int8_pull_compression_bit_identical():
    """Error-feedback residuals are per leaf, so int8 pulls through the
    fan-out telescope exactly as through one PS."""
    tree = _model_tree(seed=3)
    single = ParameterServer(copy.deepcopy(tree), tr.DownpourMerge(), 1)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DownpourMerge(), 1,
                           num_shards=2, transport="inprocess")
    group.initialize()
    group.start()
    c0 = group.make_client(0, pull_compression="int8")
    try:
        for k in range(3):
            a = maybe_decode(single.pull(0, compressed=True))
            assert _trees_equal(a, c0.pull())
            single.commit(0, _full(tree, 0.01 * (k + 1)))
            c0.commit(0, _full(tree, 0.01 * (k + 1)))
        assert _trees_equal(single.get_model(), group.get_model())
    finally:
        c0.close()
        group.stop()
        single.stop()


def test_shard_map_handshake_rejects_miswired_client():
    """A client wired to the wrong shard fails fast with the typed,
    non-retryable mismatch, on the plain and the resilient path; an
    unsharded server answers ``shard_map`` with None."""
    tree = _model_tree()
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DownpourMerge(), 1,
                           num_shards=2, transport="socket")
    group.initialize()
    group.start()
    try:
        a, b = group.servers[0].shard_info, group.servers[1].shard_info
        assert a == group.plan.shard_info(0)
        group.servers[0].shard_info, group.servers[1].shard_info = b, a
        with pytest.raises(ShardMapMismatchError, match="shard"):
            group.make_client(0)
        with pytest.raises(ShardMapMismatchError, match="shard"):
            group.make_client(0, resilient=True)
        group.servers[0].shard_info, group.servers[1].shard_info = a, b
        for resilient in (False, True):
            group.make_client(0, resilient=resilient).close()
        c = ParameterServerClient(group.servers[1].host,
                                  group.servers[1].port, 0)
        assert c.shard_map() == b
        c.close()
    finally:
        group.stop()


# -- chain replication -------------------------------------------------------------


def test_chain_replication_two_successive_failovers_bit_identical():
    """``chain_length=3``: records stream primary → r1 → r2. Killing the
    primary promotes r1; killing r1 promotes r2, which holds every fold,
    those streamed after the first failover too. Exactly once throughout,
    and the shard-map epoch counts both failovers."""
    tree = _model_tree(seed=5)
    single = ParameterServer(copy.deepcopy(tree), tr.DownpourMerge(), 2)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DownpourMerge(), 2,
                           num_shards=2, transport="socket", chain_length=3)
    group.initialize()
    group.start()
    group.start_supervision(failover_timeout=0.3)
    c0 = group.make_client(0, resilient=True)

    def step(k):
        single.pull(0), c0.pull()
        v = 0.01 * (k + 1)
        single.commit(0, _full(tree, v)), c0.commit(0, _full(tree, v))

    def wait_failovers(n, budget=15.0):
        t0 = time.monotonic()
        while group.failover_stats()["failovers"] < n:
            assert time.monotonic() - t0 < budget, "no failover happened"
            time.sleep(0.05)

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the failover warnings
            for k in range(4):
                step(k)
            group.servers[1]._crash()
            wait_failovers(1)
            for k in range(4, 7):
                step(k)
            group.supervisors[1].active._crash()
            wait_failovers(2)
            for k in range(7, 9):
                step(k)
        assert _trees_equal(single.get_model(), group.get_model())
        s = group.stats()
        assert s["num_updates"] == s["num_updates_max"] == 9
        assert c0.seq == 9
        assert group.map_epoch == 2
        assert group.supervisors[1].active is group.chains[1][1]
        log = group.failover_stats()["per_shard"][1]["failover_log"]
        assert [e["via"] for e in log] == ["standby", "standby"]
    finally:
        c0.close()
        group.stop()
        single.stop()


# -- across packages -----------------------------------------------------------------


def _port_group(tree, n):
    return ShardedPSGroup(copy.deepcopy(tree), tr.DynSGDMerge(), 2,
                          num_shards=n, transport="socket")


def _jax_group(tree, n):
    return jsh.ShardedPSGroup(copy.deepcopy(tree), jr.DynSGDMerge(), 2,
                              num_shards=n, transport="socket")


@pytest.mark.parametrize("direction", ["jax-client-port-group",
                                       "port-client-jax-group"])
def test_mixed_fleet_folds_bit_equal(direction):
    """A JAX ``ShardedPSClient`` folding into a port group, and a port
    client into a JAX group, over sockets: both plans agree, the shard-map
    handshake passes, and the center is a single PS's, bit for bit."""
    tree = _model_tree(seed=2)
    if direction == "jax-client-port-group":
        group, client_plan = _port_group(tree, 3), jsh.ShardPlan(tree, 3)
        client_cls, sub_cls = jsh.ShardedPSClient, JClient
    else:
        group, client_plan = _jax_group(tree, 3), ShardPlan(tree, 3)
        client_cls, sub_cls = tsh.ShardedPSClient, ParameterServerClient
    assert client_plan.digest == group.plan.digest
    single = ParameterServer(copy.deepcopy(tree), tr.DynSGDMerge(), 2)
    group.initialize()
    group.start()
    clients = []
    try:
        for wid in (0, 1):
            subs = [sub_cls(s.host, s.port, wid) for s in group.servers]
            for sub in subs:
                sub._sock.settimeout(60.0)
            clients.append(client_cls(subs, client_plan, wid))
            clients[-1].verify_shard_map()
        _fold_script(single, *clients, tree)
        assert _trees_equal(single.get_model(), group.get_model())
        s = group.stats()
        assert s["num_updates"] == s["num_updates_max"] == 3
    finally:
        for c in clients:
            c.close()
        group.stop()
        single.stop()


# -- trainer integration -------------------------------------------------------------


_KW = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
           batch_size=32, communication_window=2, num_epoch=2,
           backend="ps", device="cpu")


def test_trainer_sharded_socket_bit_identical_to_single():
    """The same deterministic one-worker run lands on the same weights,
    bit for bit, at ``ps_num_shards=2`` as on one PS; the stats carry
    both shapes and serialise."""
    ds = Dataset.from_arrays(*blobs(n=512))

    def run(**kw):
        t = trainers.ADAG(_spec(), learning_rate=0.1, num_workers=1,
                          ps_transport="socket", **_KW, **kw)
        return t, _watchdog(lambda: t.train(ds, shuffle=False))

    t1, p1 = run()
    t2, p2 = run(ps_num_shards=2)
    assert sorted(p1) == sorted(p2)
    for k in p1:
        np.testing.assert_array_equal(p1[k].numpy(), p2[k].numpy())
    s = t2.ps_stats_
    assert s["num_shards"] == 2 and len(s["per_shard"]) == 2
    assert s["num_updates"] == s["num_updates_max"] == t1.ps_stats_[
        "num_updates"]
    json.dumps(t1.ps_stats_)
    json.dumps(t2.ps_stats_)


@pytest.mark.parametrize("transport", ["inprocess", "socket", "shm",
                                       "native"])
def test_trainer_sharded_on_each_transport_trains(transport):
    """DynSGD with two workers over a 2-shard center on each transport:
    every shard folds every commit, and the loss falls."""
    ds = Dataset.from_arrays(*blobs(n=1024))
    t = trainers.DynSGD(_spec(), learning_rate=0.05, num_workers=2,
                        ps_transport=transport, ps_num_shards=2, **_KW)
    _watchdog(lambda: t.train(ds, shuffle=True))
    s = t.ps_stats_
    commits = 2 * 2 * 1024 // (2 * 32 * 2)
    assert s["num_updates"] == s["num_updates_max"] == commits
    assert s["num_shards"] == 2
    assert all(p["num_updates"] == commits for p in s["per_shard"])
    assert _final_loss(t) < 0.6


def test_trainer_kill_one_shard_exactly_once(tmp_path):
    """Shard 1's primary is crash-stopped in its commit path; its chain
    promotes while shard 0 keeps folding. The run completes and learns,
    and every shard's lifetime folds equal the logical commits."""
    ds = Dataset.from_arrays(*blobs(n=1024))
    plan = FaultPlan(seed=0, kill_ps_after_commits=6, kill_shard_id=1)
    t = trainers.DOWNPOUR(
        _spec(), learning_rate=0.02, num_workers=2, ps_transport="socket",
        ps_num_shards=2, ps_chain_length=2,
        ps_wal_dir=str(tmp_path / "wal"), fault_plan=plan,
        heartbeat_interval=0.2, ps_failover_timeout=0.5, **_KW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the failover warning
        with plan:
            _watchdog(lambda: t.train(ds, shuffle=True))
    rs, s = t.resilience_stats_, t.ps_stats_
    assert rs["faults"]["ps_kills"] == 1
    assert rs["ps_failover"]["failovers"] >= 1
    assert rs["ps_failover"]["per_shard"][1]["failovers"] >= 1
    assert s["num_updates"] == s["num_updates_max"] == \
        rs["logical_commits"]
    assert _final_loss(t) < 0.6


def test_trainer_chain_of_two_on_one_shard_is_the_standby():
    """``ps_num_shards=1, ps_chain_length=2`` is the single hot standby's
    topology: the primary killed mid-run, the chain's replica takes over
    at fence epoch 1, exactly once."""
    ds = Dataset.from_arrays(*blobs(n=512))
    plan = FaultPlan(kill_ps_after_commits=5)
    t = trainers.ADAG(_spec(), learning_rate=0.1, num_workers=2,
                      ps_transport="socket", ps_chain_length=2,
                      fault_plan=plan, ps_failover_timeout=0.5, **_KW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with plan:
            _watchdog(lambda: t.train(ds, shuffle=True))
    fo = t.resilience_stats_["ps_failover"]
    assert fo["failovers"] == 1
    assert fo["per_shard"][0]["failover_log"][0]["via"] == "standby"
    assert fo["per_shard"][0]["failover_log"][0]["epoch"] == 1
    assert t.ps_stats_["num_updates"] == \
        t.resilience_stats_["logical_commits"]


def test_trainer_validates_shard_knobs():
    """The JAX package's checks: chains only on socket, not beside
    ``ps_standby``, counts >= 1, the PS backend only, no external
    ``ps_host``, ``kill_shard_id`` in range; a chain is a recovery path
    for a PS kill."""
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              num_workers=2, backend="ps", device="cpu")
    with pytest.raises(ValueError, match="socket"):
        trainers.ADAG(_spec(), ps_chain_length=2, **kw)
    with pytest.raises(ValueError, match="chain"):
        trainers.ADAG(_spec(), ps_transport="socket", ps_num_shards=2,
                      ps_standby=True, **kw)
    with pytest.raises(ValueError, match="ps_num_shards"):
        trainers.ADAG(_spec(), ps_num_shards=0, **kw)
    with pytest.raises(ValueError, match="ps_chain_length"):
        trainers.ADAG(_spec(), ps_transport="socket", ps_chain_length=0,
                      **kw)
    with pytest.raises(ValueError, match="backend"):
        trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", num_workers=2, ps_num_shards=2,
                      device="cpu")
    with pytest.raises(ValueError, match="ps_host"):
        trainers.ADAG(_spec(), ps_transport="socket", ps_host="127.0.0.1",
                      ps_num_shards=2, **kw)
    with pytest.raises(ValueError, match="out of range"):
        trainers.ADAG(_spec(), ps_transport="socket", ps_num_shards=2,
                      ps_chain_length=2, fault_plan=FaultPlan(
                          kill_ps_after_commits=3, kill_shard_id=2), **kw)
    t = trainers.ADAG(_spec(), ps_transport="socket", ps_chain_length=2,
                      fault_plan=FaultPlan(kill_ps_after_commits=3), **kw)
    assert (t.ps_num_shards, t.ps_chain_length) == (1, 2)
    for name in ("DOWNPOUR", "AEASGD", "EAMSGD", "DynSGD"):
        t = getattr(trainers, name)(_spec(), ps_transport="socket",
                                    ps_num_shards=3, ps_chain_length=2, **kw)
        assert (t.ps_num_shards, t.ps_chain_length) == (3, 2)


# -- the sharded WAL -----------------------------------------------------------------


def test_wal_verify_sharded_root(tmp_path):
    """``wal verify`` on a sharded root: one report over every shard
    directory, record totals summed; a shard's own directory keeps the
    plain report's shape."""
    root = tmp_path / "wal"
    tree = _model_tree(seed=7)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DownpourMerge(), 1,
                           num_shards=2, transport="inprocess",
                           wal_root=str(root))
    group.initialize()
    group.start()
    c = group.make_client(0)
    for _ in range(4):
        c.pull()
        c.commit(0, _full(tree, 0.1))
    c.close()
    group.stop()
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.resilience.wal",
         "verify", str(root)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["ok"] and rep["sharded"]
    assert rep["num_wal_dirs"] == 2
    assert rep["record_totals"]["commit"] == 8    # 4 commits × 2 shards
    assert rep["record_totals"]["pull"] == 8
    assert sorted(d["dir"] for d in rep["dirs"]) == [
        "shard-00", "shard-01"]
    from distkeras_tpu_torch.resilience.wal import verify_tree

    sub = verify_tree(str(root / "shard-00"))
    assert sub["ok"] and "sharded" not in sub
    assert tsh.shard_wal_dir(str(root), 1) == str(root / "shard-01")
    assert tsh.chain_wal_dir(str(root), 1, 2) == str(
        root / "shard-01" / "chain-2")


# -- stats --------------------------------------------------------------------------


def test_sharded_stats_rollup_shapes():
    """The roll-up keeps the single-PS key set (summed or maxed) beside
    the raw per-shard dicts, serialises, and recomputes from them."""
    tree = _model_tree(seed=9)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.ADAGMerge(), 2,
                           num_shards=3, transport="inprocess")
    group.initialize()
    group.start()
    c0 = group.make_client(0)
    try:
        c0.pull()
        c0.commit(0, _full(tree, 0.1))
        s = group.stats()
        assert s["pulls"] == 3 and s["commits"] == 3
        assert s["num_shards"] == 3 and len(s["per_shard"]) == 3
        assert s["num_updates"] == s["num_updates_max"] == 1
        assert s["ring"] == group.plan.digest and s["map_epoch"] == 0
        assert [p["shard_nbytes"] for p in s["per_shard"]] == \
            group.plan.shard_nbytes
        for key in ("center_lock_mean_hold_ns", "pulls_per_sec",
                    "active_workers", "wal_records"):
            assert key in s
        json.dumps(s)
        again = tsh.aggregate_ps_stats(s["per_shard"])
        assert again["commits"] == s["commits"]
        jagain = jsh.aggregate_ps_stats(s["per_shard"])
        assert {k: v for k, v in jagain.items() if k != "per_shard"} == \
            {k: v for k, v in again.items() if k != "per_shard"}
    finally:
        c0.close()
        group.stop()


def test_sharded_group_refuses_later_items():
    """The metrics registry (A13) names its item; the directory's
    registration (once refused naming A7.9) registers both supervised
    shards as the JAX package does, with leases their supervisors renew;
    a sharded live join and drain, once refused naming A7.8, count on
    every shard; the center's EMA, once refused naming A8, is the join of
    the shards' EMAs (the center itself before any commit)."""
    tree = _model_tree()
    group = ShardedPSGroup(tree, tr.ADAGMerge(), 1, num_shards=2,
                           transport="socket", ema_decay=0.9)
    group.initialize()
    group.start()
    try:
        ema = group.get_ema()
        for (pa, a), (pb, b) in zip(utils.flatten_with_paths(ema)[0],
                                    utils.flatten_with_paths(tree)[0]):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
        with pytest.raises(NotImplementedError, match="A13"):
            group.metrics()
        from distkeras_tpu_torch.directory import HostedDirectory

        hosted = HostedDirectory(standby=False, failover_timeout=0.5)
        hosted.start()
        try:
            group.start_supervision(failover_timeout=0.5, directory=hosted)
            view = hosted.membership()
            assert [(e["key"], e["port"], e["epoch"], e["ttl"])
                    for e in view["entries"]] == [
                (f"shard-{sid:02d}", srv.port, 0, hosted.entry_ttl(True))
                for sid, srv in enumerate(group.servers)]
            meta = view["entries"][0]["meta"]
            assert meta == {"num_shards": 2, "ring": group.plan.digest,
                            "vnodes": group.plan.ring.vnodes,
                            "bound": group.plan.bound}
            # healthy pings renew both entries through the publish path
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not all(
                    sup.publishes for sup in group.supervisors):
                time.sleep(0.02)
            assert all(sup.publishes for sup in group.supervisors)
        finally:
            group.stop_supervision()
            hosted.stop()
        # a sharded live join and drain (once refused naming A7.8) register
        # and drain on both shards
        c = group.make_client(0)
        assert c.join()["pool_size"] == 2
        c.drain()
        for srv in group.servers:
            st = srv.stats()
            assert (st["pool_size"], st["joined_workers"],
                    st["preempted_workers"]) == (1, 1, 1)
        c.close()
    finally:
        group.stop()


# -- the native and shm transports --------------------------------------------------


def test_native_sharded_parity_and_shard_info():
    """Native shard servers: the group's folds equal one PS's within the
    native fold's f32 arithmetic, and the SHARD_INFO handshake reports each
    server's shard."""
    tree = {"a": np.ones(64, np.float32) * 0.5,
            "b": np.ones(32, np.float32) * 2.0,
            "c": np.ones(16, np.float32)}
    single = ParameterServer(copy.deepcopy(tree), tr.DynSGDMerge(), 2)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DynSGDMerge(), 2,
                           num_shards=2, transport="native")
    group.initialize()
    group.start()
    c0, c1 = group.make_client(0), group.make_client(1)
    try:
        single.pull(0), c0.pull()
        single.pull(1), c1.pull()
        single.commit(0, _full(tree, 0.25)), c0.commit(0, _full(tree, 0.25))
        single.commit(1, _full(tree, 0.5)), c1.commit(1, _full(tree, 0.5))
        assert _trees_equal(single.get_model(), group.get_model())
        for sid in (0, 1):
            info = c0._clients[sid].shard_info()
            assert (info["shard_id"], info["num_shards"]) == (sid, 2)
        s = group.stats()
        assert s["num_updates"] == s["num_updates_max"] == 2
    finally:
        c0.close()
        c1.close()
        group.stop()
        single.stop()


def test_shm_sharded_runs_bit_identical_with_int8_pulls():
    """Shard servers over shared-memory rings: the fan-out opens a ring
    pair a (worker, shard), answers the shard-map handshake, and folds
    (int8 pulls too) to a single PS's bits; the rings unlink at stop."""
    from distkeras_tpu_torch import shm

    tree = _model_tree(seed=4)
    single = ParameterServer(copy.deepcopy(tree), tr.DynSGDMerge(), 2)
    group = ShardedPSGroup(copy.deepcopy(tree), tr.DynSGDMerge(), 2,
                           num_shards=2, transport="shm")
    group.initialize()
    group.start()
    c0 = group.make_client(0, pull_compression="int8")
    c1 = group.make_client(1)
    names = {rec["seg"].name for srv in group.servers
             for rec in srv._segments}
    try:
        assert [c.shard_map() for c in c0._clients] == [
            group.plan.shard_info(s) for s in (0, 1)]
        for k in range(2):
            a = maybe_decode(single.pull(0, compressed=True))
            assert _trees_equal(a, c0.pull())
            single.pull(1), c1.pull()
            d0, d1 = _full(tree, 0.1 * (k + 1)), _full(tree, 0.05)
            single.commit(0, d0), c0.commit(0, d0)
            single.commit(1, d1), c1.commit(1, d1)
        assert _trees_equal(single.get_model(), group.get_model())
    finally:
        c0.close()
        c1.close()
        group.stop()
        single.stop()
    live = {s["name"] for s in shm.segment_inventory()["segments"]}
    assert names and not names & live
