"""The port's checkpoints (distkeras_tpu_torch/checkpoint.py, the trainers'
checkpoint_dir / resume / checkpoint_async on both backends, the PS
backend's epoch barrier and worker restores) held against the JAX
package's own oracles (tests/test_aux.py, tests/test_ps_backend.py) and
across the two packages, on the CPU.

Tolerances: a port resume equals the uninterrupted port run exactly
(tolerance 0: the same ops on the same values, in the same order, on the
CPU), as does a checkpoint written asynchronously against a synchronous
one; a center the JAX package wrote restores bit for bit (f32 leaves, a
copy); a port center resuming the JAX engine agrees with the port's own
continuation within 1e-6 absolute in f32 (the bound
tests/test_torch_trainers.py holds one window of the two engines to).

Every test stops every server and thread it starts (the trainers join
their workers and stop their servers before they return).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.ops.losses import sparse_softmax_cross_entropy as jax_ce
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.parallel.local_sgd import LocalSGDEngine as JaxEngine
from distkeras_tpu.parallel.mesh import get_mesh
from distkeras_tpu_torch import checkpoint as ckpt
from distkeras_tpu_torch import optim, trainers, utils
from distkeras_tpu_torch.convert import (
    center_from_jax,
    params_to_jax,
    tensors_from_jax,
)
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.ops.losses import (
    sparse_softmax_cross_entropy as torch_ce,
)
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine, TrainState
from distkeras_tpu_torch.resilience import FaultPlan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def blobs(n=512, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(classes, dim)).astype(np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    x = centers[labels] + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32)
    return x, labels


def _ds(n=512):
    return Dataset.from_arrays(*blobs(n))


def _spec():
    return torch_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                     dtype=torch.float32)


def _jspec():
    return jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                   dtype=jnp.float32)


_COMMON = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
               learning_rate=0.05, num_workers=4, batch_size=16,
               communication_window=2, seed=9, device="cpu")


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _steps(d) -> list[int]:
    return sorted(s for s, _ in ckpt._all_checkpoint_files(d))


# -- the file format ------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones(4, np.int32)}}
    ckpt.save_checkpoint(tmp_path, tree, step=3)
    ckpt.save_checkpoint(tmp_path, {"a": tree["a"] * 2,
                                    "nested": tree["nested"]}, step=7)
    assert ckpt.latest_step(tmp_path) == 7
    assert json.loads((tmp_path / "latest.json").read_text()) == {
        "step": 7, "file": "ckpt_000000000007.dkc"}
    restored, step = ckpt.restore_checkpoint(tmp_path)
    assert step == 7
    np.testing.assert_array_equal(restored["a"], tree["a"] * 2)
    old, _ = ckpt.restore_checkpoint(tmp_path, step=3)
    np.testing.assert_array_equal(old["a"], tree["a"])
    np.testing.assert_array_equal(old["nested"]["b"], tree["nested"]["b"])
    assert ckpt.load_checkpoint(tmp_path).origin == "port"
    assert not list(tmp_path.glob(".tmp_*"))     # written atomically


def test_checkpoint_keep_prunes(tmp_path):
    for s in range(6):
        ckpt.save_checkpoint(tmp_path, {"x": np.zeros(1)}, step=s, keep=2)
    assert _steps(tmp_path) == [4, 5]


def test_checkpoint_rollback_save_not_pruned(tmp_path):
    """A run resumed from a rollback saves a LOWER step than stale future
    checkpoints; its fresh save survives (and wins) pruning."""
    for s in (150, 151, 152):
        ckpt.save_checkpoint(tmp_path, {"w": np.zeros(1)}, step=s)
    path = ckpt.save_checkpoint(tmp_path, {"w": np.ones(1)}, step=101)
    assert path.exists()
    got, _ = ckpt.restore_checkpoint(tmp_path, step=101)
    np.testing.assert_array_equal(got["w"], np.ones(1))


def test_checkpoint_rollback_truncates_abandoned_future(tmp_path):
    for s in (150, 151, 152):
        ckpt.save_checkpoint(tmp_path, {"w": np.zeros(1)}, step=s)
    ckpt.save_checkpoint(tmp_path, {"w": np.ones(1)}, step=101)
    assert ckpt.latest_step(tmp_path) == 101        # not the dead 152
    for s in (102, 103):
        ckpt.save_checkpoint(tmp_path, {"w": np.ones(1) * s}, step=s)
    assert _steps(tmp_path) == [101, 102, 103]
    got, _ = ckpt.restore_checkpoint(tmp_path)
    np.testing.assert_array_equal(got["w"], np.ones(1) * 103)


def test_checkpoint_cross_format_step_collision(tmp_path):
    """Both formats at one step (a directory reused across a topology
    change): the newer write decides, and a sharded one names A12; pruning
    removes old steps of both formats."""
    ckpt.save_checkpoint(tmp_path, {"w": np.zeros(4)}, step=3)
    meta = tmp_path / "ckpt_000000000003.meta.dks"
    time.sleep(0.05)
    meta.write_bytes(b"written by a multi-process run")
    (tmp_path / "latest.json").write_text(json.dumps(
        {"step": 3, "file": meta.name}))
    with pytest.raises(NotImplementedError, match="A12"):
        ckpt.restore_checkpoint(tmp_path, step=3)
    (tmp_path / "latest.json").write_text(json.dumps(
        {"step": 3, "file": "ckpt_000000000003.dkc"}))
    got, _ = ckpt.restore_checkpoint(tmp_path, step=3)   # the index decides
    np.testing.assert_array_equal(got["w"], np.zeros(4))
    for s in (0, 1):
        (tmp_path / f"ckpt_{s:012d}.p00000of00002.dks").write_bytes(b"x")
        (tmp_path / f"ckpt_{s:012d}.meta.dks").write_bytes(b"x")
    for s in (4, 5, 6):
        ckpt.save_checkpoint(tmp_path, {"w": np.ones(1)}, step=s)
    assert _steps(tmp_path) == [4, 5, 6]


def test_sharded_only_step_names_a12(tmp_path):
    (tmp_path / "ckpt_000000000002.meta.dks").write_bytes(b"x")
    assert ckpt.latest_step(tmp_path) == 2
    with pytest.raises(NotImplementedError, match="A12"):
        ckpt.restore_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "empty")


def test_corrupt_checkpoint_raises(tmp_path):
    ckpt.save_checkpoint(tmp_path, {"w": np.zeros(4)}, step=0)
    path = tmp_path / "ckpt_000000000000.dkc"
    path.write_bytes(path.read_bytes()[:40])
    with pytest.raises(ValueError, match="truncated or corrupt"):
        ckpt.restore_checkpoint(tmp_path)


def test_should_checkpoint_cadence_matches_jax():
    from distkeras_tpu import checkpoint as jckpt

    for every in (1, 2, 3):
        for n in (1, 4, 5):
            assert [ckpt.should_checkpoint(e, every, n) for e in range(n)] \
                == [jckpt.should_checkpoint(e, every, n) for e in range(n)]


@dataclasses.dataclass
class _Point:
    b: object
    a: object


def test_flatten_walks_dataclasses_and_namedtuples():
    """The tree walk of the checkpoints: a dataclass in field order (as
    jax.tree walks a flax struct), a NamedTuple as its fields, both rebuilt
    as their own types; dict keys sorted."""
    Pair = optim.GradientTransformation     # a NamedTuple of the port
    tree = {"z": _Point(b=np.ones(2), a=(np.zeros(1), None)),
            "p": Pair(init=np.full(3, 2.0), update=[np.arange(2)])}
    leaves, st = utils.flatten(tree)
    assert [len(np.atleast_1d(x)) for x in leaves] == [3, 2, 2, 1]
    back = utils.unflatten(st, leaves)
    assert isinstance(back["z"], _Point) and isinstance(back["p"], Pair)
    assert back["z"].a[1] is None
    np.testing.assert_array_equal(back["p"].update[0], np.arange(2))
    pairs, _ = utils.flatten_with_paths(tree)
    assert [p for p, _ in pairs] == ["['p'].init", "['p'].update[0]",
                                     "['z'].b", "['z'].a[0]"]
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  {"p": jax.tree_util.tree_map(lambda x: x, tree["p"])})[0]]
    assert jpaths == ["['p'].init", "['p'].update[0]"]


def test_train_state_flattens_in_the_jax_field_order():
    assert [f.name for f in dataclasses.fields(TrainState)] == \
        list(ckpt._REFERENCE_FIELDS[
            "distkeras_tpu.parallel.local_sgd.TrainState"])
    from distkeras_tpu.parallel.local_sgd import TrainState as JState

    assert [f.name for f in dataclasses.fields(JState)] == \
        [f.name for f in dataclasses.fields(TrainState)]


def test_serialize_weights_keeps_bf16_and_ints():
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16), "count": 7,
            "m": np.arange(3, dtype=np.float32)}
    back = utils.deserialize_weights(utils.serialize_weights(tree))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert int(back["count"]) == 7
    np.testing.assert_array_equal(back["m"], tree["m"])


# -- the collective backend -------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_trainer_resume_continues(tmp_path, optimizer):
    """Two epochs with checkpoints == one, a resume, one more, exactly
    (tolerance 0); the resume trains epoch 1 only. Adam shows the
    optimizer state restored (plain SGD would pass without it)."""
    ds = _ds()
    kw = dict(_COMMON, worker_optimizer=optimizer,
              learning_rate=0.05 if optimizer == "sgd" else 5e-3)
    full = trainers.ADAG(_spec(), num_epoch=2, **kw).train(ds)
    d = tmp_path / "ck"
    trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=d, **kw).train(ds)
    t2 = trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=d, resume=True,
                       **kw)
    resumed = t2.train(ds)
    assert _equal(full, resumed)
    assert {r.get("epoch") for r in t2.get_history()} == {1}
    assert t2.state_.step == 2 * (512 // (4 * 2 * 16))


def test_resume_with_nothing_to_resume_trains_from_scratch(tmp_path):
    ds = _ds()
    full = trainers.ADAG(_spec(), num_epoch=1, **_COMMON).train(ds)
    t = trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=tmp_path / "n",
                      resume=True, **_COMMON)
    assert _equal(full, t.train(ds))
    assert _steps(tmp_path / "n") == [0]


def test_checkpoint_every_and_the_final_epoch(tmp_path):
    trainers.ADAG(_spec(), num_epoch=5, checkpoint_dir=tmp_path,
                  checkpoint_every=2, **_COMMON).train(_ds(256))
    assert _steps(tmp_path) == [1, 3, 4]
    payload, step = ckpt.restore_checkpoint(tmp_path)
    assert step == 4 and int(payload["epoch"]) == 4
    assert isinstance(payload["state"], TrainState)


def test_collective_worker_count_mismatch_goes_elastic(tmp_path):
    ds = _ds()
    d = tmp_path / "ck"
    t1 = trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=d, **_COMMON)
    c1 = t1.train(ds)
    t2 = trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=d, resume=True,
                       **dict(_COMMON, num_workers=2))
    with pytest.warns(UserWarning, match="elastic resume"):
        t2.train(ds)
    assert {r.get("epoch") for r in t2.get_history()} == {1}
    # the center carried over: the resumed run's start is epoch 0's end
    t3 = trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=d, resume=True,
                       **dict(_COMMON, num_workers=2))
    ckpt.save_checkpoint(d, ckpt.restore_checkpoint(d, step=0)[0], step=0)
    with pytest.warns(UserWarning, match="elastic resume"):
        assert _equal(t3.train(ds), c1)


def test_async_checkpoint_resume_equals_sync(tmp_path):
    """checkpoint_async writes on a background thread: its files' leaves
    equal the synchronous run's bit for bit, and they resume identically."""
    ds = _ds()
    kw = dict(_COMMON, worker_optimizer="adam", learning_rate=5e-3)
    sync_d, async_d = tmp_path / "s", tmp_path / "a"
    trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=sync_d,
                  **kw).train(ds)
    trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=async_d,
                  checkpoint_async=True, **kw).train(ds)
    for step in (0, 1):
        a = utils.flatten(ckpt.restore_checkpoint(sync_d, step)[0])[0]
        b = utils.flatten(ckpt.restore_checkpoint(async_d, step)[0])[0]
        assert len(a) == len(b) > 10
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    full = trainers.ADAG(_spec(), num_epoch=3, **kw).train(ds)
    resumed = trainers.ADAG(_spec(), num_epoch=3, checkpoint_dir=async_d,
                            resume=True, checkpoint_async=True,
                            **kw).train(ds)
    assert _equal(full, resumed)


def test_async_checkpointer_copies_before_save_returns(tmp_path):
    """The host copy is taken on the caller's thread: changing the tensors
    right after save() returns does not reach the file."""
    w = torch.zeros(4)
    ac = ckpt.AsyncCheckpointer()
    ac.save(tmp_path, {"w": w}, step=0)
    w += 5.0
    ac.wait()
    np.testing.assert_array_equal(ckpt.restore_checkpoint(tmp_path)[0]["w"],
                                  np.zeros(4))


def test_async_checkpoint_error_surfaces(tmp_path):
    """A failing background save raises at the next boundary, and the
    checkpointer keeps working."""
    ac = ckpt.AsyncCheckpointer()
    target = tmp_path / "not_a_dir"
    target.write_text("file, not directory")
    ac.save(target / "sub", {"w": np.ones(2)}, step=0)
    with pytest.raises((OSError, FileExistsError, NotADirectoryError)):
        ac.wait()
    ac.save(tmp_path / "ok", {"w": np.ones(2)}, step=1)
    ac.wait()
    assert ckpt.latest_step(tmp_path / "ok") == 1


def test_async_checkpoint_failure_fails_the_run(tmp_path):
    target = tmp_path / "a_file"
    target.write_text("not a directory")
    t = trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=target / "sub",
                      checkpoint_async=True, **_COMMON)
    with pytest.raises((OSError, FileExistsError, NotADirectoryError)):
        t.train(_ds(256))


def test_async_checkpoint_rejected_on_ps_backend():
    t = trainers.DOWNPOUR(_spec(), backend="ps", checkpoint_dir="/tmp/x",
                          checkpoint_async=True, **_COMMON)
    with pytest.raises(ValueError, match="checkpoint_async"):
        t.train(_ds(256))


def test_pipelined_ps_with_checkpoints_refused():
    with pytest.raises(ValueError, match="ps_pipeline_depth"):
        trainers.DynSGD(_spec(), backend="ps", ps_pipeline_depth=1,
                        checkpoint_dir="/tmp/x", device="cpu")


# -- the parameter-server backend ------------------------------------------------------


def test_ps_backend_resume_continues(tmp_path):
    """W=1 keeps the hogwild path deterministic: two epochs with
    checkpoints == one, a resume, one more, exactly (Adam: the restored
    optimizer state shows)."""
    ds = _ds()
    kw = dict(_COMMON, worker_optimizer="adam", learning_rate=2e-3,
              num_workers=1, backend="ps")
    full = trainers.ADAG(_spec(), num_epoch=2, **kw).train(ds)
    d = tmp_path / "ck"
    t1 = trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=d, **kw)
    t1.train(ds)
    assert _steps(d) == [0] and len(t1.checkpoint_ms_) == 1
    payload, _ = ckpt.restore_checkpoint(d)
    assert int(payload["num_updates"]) == t1.ps_stats_["num_updates"] == 16
    t2 = trainers.ADAG(_spec(), num_epoch=2, checkpoint_dir=d, resume=True,
                       **kw)
    resumed = t2.train(ds)
    assert _equal(full, resumed)
    assert {r.get("epoch") for r in t2.get_history() if "loss" in r} == {1}
    # the fold count continues from the saved one
    assert t2.ps_stats_["num_updates"] == 32


@pytest.mark.parametrize("transport", ["inprocess", "socket", "shm",
                                       "native"])
def test_ps_backend_resume_multiworker(tmp_path, transport):
    """W=4 hogwild on every transport: checkpoints at epoch barriers, and a
    resume trains only the remaining epochs with the fold count continued
    (bit-equality is not defined for hogwild interleavings)."""
    ds = _ds(1024)
    kw = dict(_COMMON, learning_rate=0.02, backend="ps",
              ps_transport=transport)
    d = tmp_path / "ck"
    t1 = trainers.DOWNPOUR(_spec(), num_epoch=2, checkpoint_dir=d, **kw)
    t1.train(ds)
    assert _steps(d) == [0, 1]
    payload, _ = ckpt.restore_checkpoint(d)
    assert len(payload["workers"]) == 4
    assert int(payload["num_updates"]) == t1.ps_stats_["num_updates"]
    t2 = trainers.DOWNPOUR(_spec(), num_epoch=3, checkpoint_dir=d,
                           resume=True, **kw)
    t2.train(ds)
    hist = [r for r in t2.get_history() if "loss" in r]
    assert {r["epoch"] for r in hist} == {2}
    assert np.all(np.isfinite([r["loss"] for r in hist]))
    assert t2.ps_stats_["num_updates"] == \
        int(payload["num_updates"]) + len(hist)


def test_ps_backend_resume_worker_count_mismatch_goes_elastic(tmp_path):
    ds = _ds()
    kw = dict(_COMMON, backend="ps", checkpoint_dir=tmp_path / "ck")
    trainers.DOWNPOUR(_spec(), num_epoch=2, **dict(kw, num_workers=2)
                      ).train(ds)
    t2 = trainers.DOWNPOUR(_spec(), num_epoch=4, resume=True, **kw)
    with pytest.warns(UserWarning, match="elastic resume"):
        t2.train(ds)
    hist = [r for r in t2.get_history() if "loss" in r]
    assert {r["epoch"] for r in hist} == {2, 3}
    assert np.all(np.isfinite([r["loss"] for r in hist]))


def test_sharded_ps_checkpoint_and_resume(tmp_path):
    """A sharded center checkpoints its joined center and marks the epoch
    on every shard; the resume seeds every shard's fold count."""
    ds = _ds()
    kw = dict(_COMMON, backend="ps", ps_num_shards=2, num_workers=2)
    d = tmp_path / "ck"
    t1 = trainers.DOWNPOUR(_spec(), num_epoch=1, checkpoint_dir=d, **kw)
    c1 = t1.train(ds)
    payload, _ = ckpt.restore_checkpoint(d)
    for k in c1:
        np.testing.assert_array_equal(payload["center"][k], c1[k].numpy())
    t2 = trainers.DOWNPOUR(_spec(), num_epoch=2, checkpoint_dir=d,
                           resume=True, **kw)
    t2.train(ds)
    s = t2.ps_stats_
    assert s["num_updates"] == s["num_updates_max"] == \
        2 * int(payload["num_updates"])


def test_worker_restarts_from_its_barrier_snapshot(tmp_path):
    """A worker killed after the first epoch barrier restarts from its
    snapshot there (not a center pull), past that epoch; the exactly-once
    oracle holds."""
    ds = _ds(1024)
    plan = FaultPlan(kill_at={1: 4})     # 4 windows an epoch: epoch 1's first
    t = trainers.DOWNPOUR(_spec(), num_epoch=2, backend="ps",
                          checkpoint_dir=tmp_path, worker_restart_budget=1,
                          tolerate_worker_failures=True,
                          fault_plan=plan, **dict(_COMMON, learning_rate=0.02,
                                                  batch_size=32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t.train(ds)
    log = t.resilience_stats_
    assert [r["from"] for r in log["restart_log"]] == ["snapshot"]
    hist = [r for r in t.get_history() if "loss" in r]
    # every window exchanged once: the restart retrained no epoch-0 window
    assert t.ps_stats_["num_updates"] == len(hist) == 4 * 8
    assert [r["epoch"] for r in hist if r["worker"] == 1] == [0] * 4 + [1] * 4


def test_worker_restarts_from_the_checkpoint_on_disk(tmp_path):
    """A worker that dies before its first barrier restores from the newest
    checkpoint on disk (the supervisor's fallback)."""
    ds = _ds(1024)
    kw = dict(_COMMON, learning_rate=0.02, batch_size=32, backend="ps",
              checkpoint_dir=tmp_path)
    trainers.DOWNPOUR(_spec(), num_epoch=1, **kw).train(ds)
    t = trainers.DOWNPOUR(_spec(), num_epoch=1, worker_restart_budget=1,
                          tolerate_worker_failures=True,
                          fault_plan=FaultPlan(kill_at={2: 1}), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t.train(ds)
    assert [r["from"] for r in t.resilience_stats_["restart_log"]] == \
        ["checkpoint"]
    hist = [r for r in t.get_history() if "loss" in r]
    # worker 2 exchanged one window, died, and retrained the epoch
    assert t.ps_stats_["num_updates"] == len(hist) == 3 * 4 + 1 + 4


def test_worker_failure_with_checkpointing_keeps_survivors(monkeypatch,
                                                           tmp_path):
    """A death that breaks the checkpoint barrier neither hangs nor kills
    the survivors when failures are tolerated."""
    from distkeras_tpu_torch import workers as workers_mod

    orig = workers_mod.AsyncWorker._train

    def dying(self, index, shard_cols, num_epoch, shuffle, seed):
        if self.worker_id == 0:
            raise RuntimeError("early death")
        return orig(self, index, shard_cols, num_epoch, shuffle, seed)

    monkeypatch.setattr(workers_mod.AsyncWorker, "_train", dying)
    t = trainers.DOWNPOUR(_spec(), num_epoch=3, backend="ps",
                          checkpoint_dir=tmp_path / "ck",
                          tolerate_worker_failures=True, **_COMMON)
    with pytest.warns(UserWarning, match="1 of 4 PS workers failed"):
        t.train(_ds())
    losses = [r["loss"] for r in t.get_history() if "loss" in r]
    assert len(losses) > 0 and np.all(np.isfinite(losses))


def test_external_ps_checkpoint_uses_a_sentinel_client(tmp_path):
    """Against an external PS the barrier pulls the center on a client of
    its own (worker id 2**32 − 1): the training workers' pull versions are
    the only ones their commits are priced from."""
    from distkeras_tpu_torch import parameter_servers as tps

    spec = _spec()
    params, _ = spec.init_np(9)
    ps = tps.SocketParameterServer(params, tr.DownpourMerge(), 2)
    ps.initialize()
    ps.start()
    try:
        t = trainers.DOWNPOUR(spec, num_epoch=1, backend="ps",
                              ps_transport="socket", ps_host="127.0.0.1",
                              ps_port=ps.port, checkpoint_dir=tmp_path,
                              **dict(_COMMON, num_workers=2))
        t.train(_ds(256))
        payload, _ = ckpt.restore_checkpoint(tmp_path)
        assert "num_updates" not in payload   # the server keeps its count
        assert 2**32 - 1 in ps._pull_versions
        live = ps.get_model()
        for k in live:
            np.testing.assert_array_equal(payload["center"][k], live[k])
    finally:
        ps.stop()


# -- across the two packages ------------------------------------------------------


def _jax_checkpoint(tmp_path, **over):
    """A JAX ADAG run (4 workers, Adam) writing its epoch-0 checkpoint:
    ``(its returned center, the directory)``."""
    from tests.test_trainers import blobs_dataset

    d = tmp_path / "jck"
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="adam",
              learning_rate=5e-3, num_workers=4, batch_size=16,
              communication_window=2, num_epoch=1, checkpoint_dir=d)
    kw.update(over)
    center = jdk.ADAG(_jspec(), **kw).train(blobs_dataset(n=512))
    return jax.device_get(center), d


def test_jax_written_checkpoint_restores_its_center_exactly(tmp_path):
    """A ``.dkc`` the JAX trainer wrote (a jax PyTreeDef pickled beside the
    npz) loads through the stubbed unpickler: its center maps onto the
    port's spec bit for bit, and a port trainer resuming from it warns
    elastic and returns that center when no epoch is left to train."""
    jcenter, d = _jax_checkpoint(tmp_path)
    r = ckpt.load_checkpoint(d)
    assert r.origin == "jax" and r.step == 0 and int(r.tree["epoch"]) == 0
    state = r.tree["state"]
    assert set(state) == {"center", "workers", "nt", "opt_state", "step"}
    assert int(state["step"]) == 512 // (4 * 2 * 16)
    spec = _spec()
    got = center_from_jax(state["center"], spec)
    want = tensors_from_jax(jcenter, spec.module)
    assert _equal(got, want)
    t = trainers.ADAG(spec, num_epoch=1, checkpoint_dir=d, resume=True,
                      **dict(_COMMON, worker_optimizer="adam"))
    with pytest.warns(UserWarning, match="elastic resume"):
        out = t.train(_ds())
    assert _equal(out, want)
    assert not [r for r in t.get_history() if "loss" in r]
    assert t.state_.step == int(state["step"])


def test_jax_checkpoint_resumes_the_port_for_the_remaining_epochs(tmp_path):
    jcenter, d = _jax_checkpoint(tmp_path)
    t = trainers.ADAG(_spec(), num_epoch=3, checkpoint_dir=d, resume=True,
                      **dict(_COMMON, worker_optimizer="adam",
                             learning_rate=5e-3))
    with pytest.warns(UserWarning, match="elastic resume"):
        t.train(_ds())
    assert {r.get("epoch") for r in t.get_history()} == {1, 2}
    # the port's own checkpoints now follow the JAX one's in the directory
    assert _steps(d) == [0, 1, 2]
    assert ckpt.load_checkpoint(d).origin == "port"
    assert ckpt.load_checkpoint(d, 0).origin == "jax"


def test_jax_written_ps_checkpoint_resumes_the_port_ps(tmp_path):
    """The JAX PS backend's checkpoint (center, worker snapshots with optax
    state, epoch, fold count): the port takes the center and the fold
    count, and its workers restart elastically."""
    from tests.test_trainers import blobs_dataset

    d = tmp_path / "jps"
    jt = jdk.DOWNPOUR(_jspec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="adam", learning_rate=2e-3,
                      num_workers=2, batch_size=16, communication_window=2,
                      num_epoch=1, backend="ps", checkpoint_dir=d)
    jcenter = jax.device_get(jt.train(blobs_dataset(n=512)))
    r = ckpt.load_checkpoint(d)
    assert r.origin == "jax" and len(r.tree["workers"]) == 2
    saved = int(r.tree["num_updates"])
    assert saved == jt.ps_stats_["num_updates"] > 0
    spec = _spec()
    assert _equal(center_from_jax(r.tree["center"], spec),
                  tensors_from_jax(jcenter, spec.module))
    t = trainers.DOWNPOUR(spec, num_epoch=2, checkpoint_dir=d, resume=True,
                          backend="ps", **dict(_COMMON, num_workers=2,
                                               worker_optimizer="adam",
                                               learning_rate=2e-3))
    with pytest.warns(UserWarning, match="elastic resume"):
        t.train(_ds())
    hist = [x for x in t.get_history() if "loss" in x]
    assert {x["epoch"] for x in hist} == {1}
    assert t.ps_stats_["num_updates"] == saved + len(hist)


def test_a_misread_reference_checkpoint_never_loads_quietly(tmp_path):
    """A JAX checkpoint of another width is refused at the spec's shapes;
    a treedef that does not cover the npz is refused by the reader."""
    _, d = _jax_checkpoint(tmp_path)
    wide = torch_mlp(input_shape=(16,), hidden=(48,), num_classes=4,
                     dtype=torch.float32)
    t = trainers.ADAG(wide, num_epoch=2, checkpoint_dir=d, resume=True,
                      **_COMMON)
    with pytest.raises(ValueError, match="shape"):
        t.train(_ds())
    path = sorted(d.glob("ckpt_*.dkc"))[-1]
    payload = ckpt._StubbingUnpickler(open(path, "rb")).load()
    leaves = utils.npz_leaves(payload["npz"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt._reference_tree(payload["treedef"], leaves[:-1])
    with pytest.raises(ValueError, match="cover"):
        ckpt._reference_tree(payload["treedef"], leaves + [np.zeros(1)])


def test_reference_checkpoint_reads_without_jax(tmp_path):
    """The reader needs no JAX: in a process where importing jax, jaxlib,
    flax, optax or the JAX package fails, a JAX-written checkpoint still
    loads."""
    jcenter, d = _jax_checkpoint(tmp_path)
    probe = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'distkeras_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from distkeras_tpu_torch import checkpoint as c\n"
        f"r = c.load_checkpoint({str(d)!r})\n"
        "k = r.tree['state']['center']['Dense_0']['kernel']\n"
        "print(r.origin, k.shape, float(k.sum()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    origin, rest = out.stdout.split(" ", 1)
    assert origin == "jax" and rest.startswith("(16, 32)")
    k = np.asarray(jcenter["Dense_0"]["kernel"])
    assert float(rest.rsplit(" ", 1)[1]) == float(k.sum())


def test_port_checkpoint_resumes_the_jax_engine(tmp_path):
    """A port-written checkpoint, read by the port and mapped through
    ``params_to_jax``, starts the JAX engine (``init_state``); one window
    from that center in each package agrees within 1e-6 in f32."""
    ds = _ds()
    d = tmp_path / "ck"
    trainers.ADAG(_spec(), num_epoch=1, checkpoint_dir=d, **_COMMON).train(ds)
    payload, _ = ckpt.restore_checkpoint(d)
    spec = _spec()
    center = {k: torch.from_numpy(np.asarray(v))
              for k, v in payload["state"].center.items()}
    jparams = params_to_jax(center, spec.module)
    W, WIN, B = 4, 2, 16
    x, y = blobs(W * WIN * B, seed=5)
    x = x.reshape(W, WIN, B, 16)
    y = y.reshape(W, WIN, B)
    jspec = _jspec()

    def jax_step(params, nt_, b):
        out, n = jspec.apply(params, nt_, b[0], training=True)
        return jax_ce(b[1], out), n

    def torch_step(params, nt_, b):
        out, n = spec.apply(params, nt_, b[0], training=True)
        return torch_ce(b[1], out), n

    je = JaxEngine(jspec, jax_step, optax.sgd(0.05), jr.ADAGMerge(),
                   get_mesh(W), num_workers=W, window=WIN)
    jstate, jloss = je.run_window(je.init_state(jparams, {}), (x, y))
    te = LocalSGDEngine(spec, torch_step, optim.sgd(0.05), tr.ADAGMerge(),
                        device="cpu", num_workers=W, window=WIN)
    tstate, tloss = te.run_window(te.init_state(center, {}), (x, y))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    back = params_to_jax(te.center_params(tstate), spec.module)
    for a, b in zip(jax.tree.leaves(jstate.center), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)
