"""The sharded group's plan knobs and methods (``ShardedPSGroup(vnodes=,
bound=)``, ``stats(settle=)``, ``make_client(verify=)``,
``initialize_and_start()``) and the small pieces of surface
(``ServerBusyError.retry_after``, ``Request.latency_s``, the ``ops``,
``models`` and top-level exports), held against the JAX package on the
CPU. Plans and centers are compared bit for bit; ``latency_s`` exactly, on
the same clock readings.
"""

import copy

import numpy as np
import pytest

import distkeras_tpu
from distkeras_tpu import networking as jnet
from distkeras_tpu import sharding as jsh
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.serving import scheduler as jsched
from distkeras_tpu_torch import networking as tnet
from distkeras_tpu_torch import sharding as tsh
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.serving import scheduler as tsched


def _tree(seed=0, layers=24):
    rng = np.random.default_rng(seed)
    return {f"block_{i:02d}": rng.normal(size=(100 + 37 * i,))
            .astype(np.float32) for i in range(layers)}


def _full(tree, value):
    return {k: np.full_like(v, value) for k, v in tree.items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_group_plan_knobs_assign_like_the_jax_group():
    """``vnodes`` and ``bound`` reach the plan: with ``vnodes=16,
    bound=1.1`` both packages' groups put the same leaves on the same
    shards, and the assignment is not the defaults' (the knobs moved
    it)."""
    tree = _tree()
    groups = [mod.ShardedPSGroup(copy.deepcopy(tree), rule, 1, num_shards=3,
                                 vnodes=16, bound=1.1)
              for mod, rule in ((jsh, jr.DownpourMerge()),
                                (tsh, tr.DownpourMerge()))]
    j, t = (g.plan for g in groups)
    assert t.assignment == j.assignment and t.digest == j.digest
    assert t.bound == 1.1 and t.ring.vnodes == 16
    assert t.assignment != tsh.ShardedPSGroup(
        copy.deepcopy(tree), tr.DownpourMerge(), 1,
        num_shards=3).plan.assignment


@pytest.mark.parametrize("transport", ["inprocess", "native"])
def test_group_stats_settle_reaches_every_shard(transport, monkeypatch):
    """``stats(settle=False)`` passes to each Python shard's
    ``stats(settle=)`` (``True`` by default); a native shard, whose
    counters need no settling, is read as it is."""
    group = tsh.ShardedPSGroup(_tree(), tr.DownpourMerge(), 1, num_shards=2,
                               transport=transport)
    group.initialize_and_start()
    seen = []
    try:
        for s in group.active_servers:
            real = s.stats

            def spy(*a, _real=real, **kw):
                seen.append(kw.get("settle"))
                return _real(*a, **kw)

            monkeypatch.setattr(s, "stats", spy)
        c = group.make_client(0)
        c.commit(0, _full(_tree(), 1.0))
        c.close()
        assert group.stats(settle=False)["commits"] == 2
        group.stats()
    finally:
        group.stop()
    want = [None] * 4 if transport == "native" else [False] * 2 + [True] * 2
    assert seen == want


def test_make_client_verify_runs_or_skips_the_handshake():
    """A client wired to the wrong shard: ``verify=True`` (the default)
    refuses it with the typed mismatch, ``verify=False`` builds it without
    the handshake, in both packages."""
    for mod, rule, err in (
            (jsh, jr.DownpourMerge(), jnet.ShardMapMismatchError),
            (tsh, tr.DownpourMerge(), tnet.ShardMapMismatchError)):
        group = mod.ShardedPSGroup(_tree(), rule, 1, num_shards=2,
                                   transport="socket")
        group.initialize_and_start()
        try:
            a, b = (s.shard_info for s in group.servers)
            group.servers[0].shard_info, group.servers[1].shard_info = b, a
            with pytest.raises(err, match="shard"):
                group.make_client(0)
            group.make_client(0, verify=False).close()
            group.servers[0].shard_info, group.servers[1].shard_info = a, b
            group.make_client(0, verify=True).close()
        finally:
            group.stop()


def test_initialize_and_start_serves_like_the_jax_group():
    """``initialize_and_start()`` brings every shard up; the same commits
    through each package's group leave bit-equal centers."""
    tree = _tree(3)
    out = []
    for mod, rule in ((jsh, jr.DynSGDMerge()), (tsh, tr.DynSGDMerge())):
        group = mod.ShardedPSGroup(copy.deepcopy(tree), rule, 2,
                                   num_shards=3, transport="socket",
                                   vnodes=16, bound=1.1)
        group.initialize_and_start()
        try:
            cs = [group.make_client(i) for i in range(2)]
            for k in range(3):
                for i, c in enumerate(cs):
                    c.pull()
                    c.commit(i, _full(tree, 0.1 * (k + 1) + i))
            for c in cs:
                c.close()
            out.append(group.get_model())
        finally:
            group.stop()
    assert _equal(*out)


def test_server_busy_error_keeps_retry_after():
    for mod in (jnet, tnet):
        e = mod.ServerBusyError()
        assert e.retry_after is None and e.retryable
        e = mod.ServerBusyError("full", retry_after=0.25, peer="p")
        assert e.retry_after == 0.25 and e.peer == "p"
    assert str(tnet.ServerBusyError()) == str(jnet.ServerBusyError())


def test_request_latency_s_matches_the_jax_request():
    """``latency_s``: None until retired, then ``t_done - t_submit``, equal
    to the JAX request's on the same clock readings."""
    kw = dict(max_new_tokens=4, temperature=0.0, top_k=None, top_p=None,
              seed=0, eos_id=None)
    reqs = [mod.Request(np.arange(3), **kw) for mod in (jsched, tsched)]
    for r in reqs:
        assert r.latency_s is None
        r.t_submit, r.t_done = 10.0, 10.375
    assert reqs[1].latency_s == reqs[0].latency_s == 0.375


def test_the_new_exports_import():
    """The ``ops`` and ``models`` exports and the top-level names the JAX
    package's ``__all__`` lists are the port modules' own objects."""
    import distkeras_tpu_torch
    from distkeras_tpu_torch import ops, resilience, trainers, utils
    from distkeras_tpu_torch.models import (
        pipelined_transformer_forward,
        sequence_parallel_transformer_forward,
        transformer,
    )
    from distkeras_tpu_torch.ops import accuracy, get_loss, losses, metrics

    assert losses is ops.losses and metrics is ops.metrics
    assert get_loss is losses.get_loss and accuracy is metrics.accuracy
    assert pipelined_transformer_forward is \
        transformer.pipelined_transformer_forward
    assert sequence_parallel_transformer_forward is \
        transformer.sequence_parallel_transformer_forward
    assert set(distkeras_tpu.__all__) <= set(distkeras_tpu_torch.__all__)
    assert distkeras_tpu_torch.FaultPlan is resilience.FaultPlan
    assert distkeras_tpu_torch.RetryPolicy is resilience.RetryPolicy
    assert distkeras_tpu_torch.utils is utils
    assert distkeras_tpu_torch.ADAG is trainers.ADAG
    assert distkeras_tpu_torch.__version__ == distkeras_tpu.__version__
