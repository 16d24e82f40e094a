"""The port's asynchronous parameter-server backend
(distkeras_tpu_torch/{networking,parameter_servers,workers}.py,
parallel/compression.py, observability/trace.py, trainers' backend="ps")
held against the JAX package on the CPU.

The PS is host numpy on both sides, so the same scripted commits give the
same centers bit for bit (tolerance 0), as do the codecs and the counters.
Training through the PS: W=4 runs must learn (final loss < 0.6, the JAX
package's own gate for this data), and W=1 runs unshuffled from the same
initial weights match the JAX package's W=1 PS run: losses within
rtol 1e-6 and the final center within 1e-5 absolute in f32 (the bound
tests/test_torch_trainers.py holds the collective path to).

No test can hang: sockets carry timeouts, threads are joined with a
timeout, and every server is stopped in a ``finally``.
"""

import os
import pickle
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu import data as jdata
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.parallel import compression as jcomp
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import networking, trainers, utils
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.observability import trace as ttrace
from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.ops.pallas_kernels import fused_adam_step
from distkeras_tpu_torch.parallel import compression as tcomp
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch import workers as tworkers
from distkeras_tpu_torch.workers import AsyncWorker

TIMEOUT = 60.0


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


def _socketpair():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    return a, b


# -- framing ------------------------------------------------------------------


def test_framing_roundtrip_over_socketpair():
    a, b = _socketpair()
    try:
        payload = {"action": "commit", "x": np.arange(5, dtype=np.float32)}
        networking.send_data(a, payload)
        got, raw = networking.recv_data_raw(b)
        assert got["action"] == "commit"
        np.testing.assert_array_equal(got["x"], payload["x"])
        assert pickle.loads(raw)["action"] == "commit"
    finally:
        a.close()
        b.close()


def test_determine_host_address_prefers_tpu_metadata(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "w0.pod,w1.pod,w2.pod")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    assert networking.determine_host_address() == "w1.pod"


def test_recv_data_rejects_oversized_frame():
    a, b = _socketpair()
    try:
        a.sendall(struct.pack(">Q", networking.MAX_FRAME_BYTES + 1))
        with pytest.raises(networking.ProtocolError, match="cap") as e:
            networking.recv_data(b)
        assert e.value.retryable is False
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("evil", ["global", "tensor"])
def test_recv_data_rejects_globals_and_tensors(evil):
    """The restricted unpickler refuses any global outside numpy's array
    reconstruction: a callable (the pickle RCE vector), and a torch tensor
    (a worker must turn its tensors into numpy before a frame is built)."""
    a, b = _socketpair()
    try:
        obj = print if evil == "global" else {"w": torch.ones(3)}
        frame = pickle.dumps(obj)
        a.sendall(struct.pack(">Q", len(frame)) + frame)
        with pytest.raises(pickle.UnpicklingError, match="disallowed"):
            networking.recv_data(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(TypeError, match="numpy"):
        tps._host_payload({"w": torch.ones(3)})


def test_error_types_match_the_jax_package():
    from distkeras_tpu import networking as jnet

    for name in ("PeerDeadError", "FencedEpochError", "ShardMapMismatchError",
                 "ProtocolError", "ServerBusyError"):
        assert issubclass(getattr(networking, name), ConnectionError)
    e = networking.FencedEpochError("x", client_epoch=1, server_epoch=2)
    j = jnet.FencedEpochError("x", client_epoch=1, server_epoch=2)
    assert (str(e), e.retryable) == (str(j), j.retryable)
    assert networking.PeerDeadError("p").retryable
    assert not networking.ShardMapMismatchError("s").retryable


# -- the in-process PS --------------------------------------------------------


def test_inprocess_ps_fold_and_version_counting():
    ps = tps.ParameterServer({"w": np.zeros(3, np.float32)},
                             tr.DownpourMerge(), num_workers=2)
    np.testing.assert_array_equal(ps.pull(0)["w"], [0, 0, 0])
    ps.commit(0, {"w": np.ones(3, np.float32)})
    ps.commit(1, {"w": np.ones(3, np.float32)})
    assert ps.num_updates == 2
    np.testing.assert_array_equal(ps.get_model()["w"], [2, 2, 2])


def test_ps_staleness_tracking_dynsgd():
    """Worker 0 pulls at version 0; two commits land before its own: τ=2,
    scale 1/3."""
    ps = tps.ParameterServer({"w": np.zeros(1, np.float32)},
                             tr.DynSGDMerge(), num_workers=3)
    ps.pull(0)
    ps.pull(1)
    ps.commit(1, {"w": np.array([3.0], np.float32)})   # τ=0 → +3
    ps.pull(2)
    ps.commit(2, {"w": np.array([4.0], np.float32)})   # τ=0 → +4
    ps.commit(0, {"w": np.array([3.0], np.float32)})   # τ=2 → +1
    np.testing.assert_allclose(ps.get_model()["w"], [8.0], rtol=0, atol=0)
    assert ps.recent_staleness() == [0, 0, 2]


def test_ps_concurrent_mixed_compressed_pulls_and_commits():
    """4 threads of mixed compressed pulls, exact pulls and commits on one
    PS: no deadlock, every commit folded once, and each worker's
    error-feedback residual still telescopes afterwards (the running mean
    of 64 more decoded pulls lies within an eighth of one pull's
    quantization error of the static center)."""
    W, ROUNDS = 4, 24
    rng = np.random.default_rng(11)
    center = {"w": rng.normal(size=(64, 32)).astype(np.float32),
              "b": rng.normal(size=(17,)).astype(np.float32)}
    ps = tps.ParameterServer(center, tr.DownpourMerge(), num_workers=W)
    delta = {"w": np.full((64, 32), 1e-3, np.float32),
             "b": np.full((17,), 1e-3, np.float32)}
    errors = []

    def worker(i):
        try:
            for r in range(ROUNDS):
                dec = tcomp.maybe_decode(ps.pull(i, compressed=True))
                assert dec["w"].shape == (64, 32)
                if r % 3 == 0:
                    ps.pull(i)
                ps.commit(i, delta)
        except BaseException as e:  # pragma: no cover - fails the test
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(W)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errors, errors
    assert ps.num_updates == W * ROUNDS
    final = ps.get_model()
    np.testing.assert_allclose(final["w"], center["w"] + W * ROUNDS * 1e-3,
                               atol=1e-4)
    T, acc = 64, None
    for _ in range(T):
        dec = tcomp.maybe_decode(ps.pull(0, compressed=True))
        leaf = np.concatenate([np.ravel(dec["w"]), np.ravel(dec["b"])])
        acc = leaf if acc is None else acc + leaf
    true = np.concatenate([np.ravel(final["w"]), np.ravel(final["b"])])
    one_pull_err = float(np.max(np.abs(true))) / 127.0 * 0.51
    assert float(np.max(np.abs(acc / T - true))) <= one_pull_err / 8
    assert set(ps._pull_errors) == set(range(W))


def test_ps_stats_counters():
    """Op and byte counts, and a center lock held only for O(1) sections
    and folds (the compressed pull's encode runs outside it)."""
    ps = tps.ParameterServer({"w": np.zeros((256, 64), np.float32)},
                             tr.DownpourMerge(), num_workers=2)
    ps.pull(0)
    ps.pull(0, compressed=True)
    ps.commit(0, {"w": np.ones((256, 64), np.float32)})
    s = ps.stats()
    assert (s["pulls"], s["compressed_pulls"], s["commits"]) == (1, 1, 1)
    assert s["bytes_out"] >= 256 * 64 * 4 + 256 * 64
    assert s["bytes_in"] == 256 * 64 * 4
    assert 3 <= s["center_lock_acquires"] <= 6
    assert s["center_lock_mean_hold_ns"] >= 0
    assert s["pulls_per_sec"] > 0 and s["commits_per_sec"] > 0
    assert set(s) == set(jps.build_ps_stats(0, 0, 0, 0, 0, 0, 0, 0, 1.0))


def _socket_ps(center, rule, n):
    ps = tps.SocketParameterServer(center, rule, num_workers=n)
    ps.initialize()
    ps.start()
    return ps


def test_socket_ps_stats_served_over_wire():
    ps = _socket_ps({"w": np.zeros(8, np.float32)}, tr.ADAGMerge(), 1)
    try:
        c = tps.ParameterServerClient("127.0.0.1", ps.port, 0, timeout=TIMEOUT)
        try:
            c.pull()
            c.commit(0, {"w": np.ones(8, np.float32)})
            wire = c.stats()
            ping = c.ping(timeout=TIMEOUT)
        finally:
            c.close()
        s = ps.stats()
        assert s["pulls"] == 1 and s["commits"] == 1
        assert (wire["pulls"], wire["commits"], wire["num_updates"]) == \
            (1, 1, 1)
        assert ping["ok"] and ping["num_updates"] == 1
    finally:
        ps.stop()


def test_socket_ps_later_actions_name_their_roadmap_item():
    ps = _socket_ps({"w": np.zeros(2, np.float32)}, tr.ADAGMerge(), 1)
    try:
        s = networking.connect("127.0.0.1", ps.port, timeout=TIMEOUT)
        try:
            for action, item in (("drain", "A7.8"), ("metrics", "A13"),
                                 ("join", "A7.8"), ("deploy_report", "A13"),
                                 ("shard_map", "A7.7")):
                networking.send_data(s, {"action": action, "worker_id": 0,
                                         "epoch": 1, "version": 1})
                reply = networking.recv_data(s)
                assert not reply["ok"] and item in reply["error"], reply
        finally:
            s.close()
    finally:
        ps.stop()


def test_socket_ps_pull_commit_concurrent():
    ps = _socket_ps({"w": np.zeros(4, np.float32),
                     "b": np.zeros(2, np.float32)}, tr.ADAGMerge(), 4)
    errors = []
    try:
        def worker(i):
            try:
                c = tps.ParameterServerClient("127.0.0.1", ps.port, i,
                                              timeout=TIMEOUT)
                for _ in range(5):
                    c.pull()
                    c.commit(i, {"w": np.full(4, 0.5, np.float32),
                                 "b": np.full(2, 0.25, np.float32)})
                c.close()
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        _join(threads)
        assert not errors, errors
        assert ps.num_updates == 20
        np.testing.assert_allclose(ps.get_model()["w"], 20 * 0.5 / 4)
        np.testing.assert_allclose(ps.get_model()["b"], 20 * 0.25 / 4)
    finally:
        ps.stop()


# -- bit parity with the JAX package's PS -------------------------------------

_RULES = {
    "ADAG": (jr.ADAGMerge, tr.ADAGMerge, {}),
    "DOWNPOUR": (jr.DownpourMerge, tr.DownpourMerge, {}),
    "AEASGD": (jr.ElasticAverageMerge, tr.ElasticAverageMerge,
               {"alpha": 0.12}),
    "EAMSGD": (jr.ElasticAverageMerge, tr.ElasticAverageMerge,
               {"alpha": 0.3}),
    "DynSGD": (jr.DynSGDMerge, tr.DynSGDMerge, {}),
}

_COUNTS = ("pulls", "compressed_pulls", "commits", "bytes_in", "bytes_out",
           "num_updates", "dup_commits", "fused_exchanges", "exchange_rtts")


def _center():
    rng = np.random.default_rng(3)
    return {"Dense_0": {"kernel": rng.normal(size=(12, 9)).astype(np.float32),
                        "bias": rng.normal(size=(9,)).astype(np.float32)},
            "step": np.arange(4, dtype=np.int32),
            "wh": rng.normal(size=(40,)).astype(np.float32)}


def _script(seed=5):
    """A fixed interleaving of three workers' pulls (exact and int8),
    commits (raw and int8-encoded) and fused exchanges."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    def payload():
        return {"Dense_0": {"kernel": normal(12, 9), "bias": normal(9)},
                "step": np.zeros(4, np.int32), "wh": normal(40)}

    ops = []
    for k in range(30):
        w = int(rng.integers(0, 3))
        kind = ("pull", "pull8", "commit", "commit8", "exchange",
                "exchange8")[k % 6 if k < 12 else int(rng.integers(0, 6))]
        ops.append((kind, w, payload()))
    return ops


def _drive(ps, ops, exchange_compressed):
    """Run the script on a PS object; return every pull's result."""
    int8 = jcomp.Int8Codec() if isinstance(ps, jps.ParameterServer) \
        else tcomp.Int8Codec()
    got = []
    for kind, w, payload in ops:
        if kind.startswith("pull"):
            got.append(ps.pull(w, compressed=kind == "pull8"))
        elif kind.startswith("commit"):
            body = int8.encode(payload) if kind == "commit8" else payload
            assert ps.commit(w, body)
        else:
            comp = kind == "exchange8" and exchange_compressed
            got.append(ps.exchange(w, payload, compressed=comp)[0])
    return got


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), utils.flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(_RULES))
def test_scripted_commits_match_the_jax_ps_bit_for_bit(name):
    jcls, tcls, kw = _RULES[name]
    ops = _script()
    jps_ = jps.ParameterServer(_center(), jcls(**kw), num_workers=3)
    tps_ = tps.ParameterServer(_center(), tcls(**kw), num_workers=3)
    jgot = _drive(jps_, ops, True)
    tgot = _drive(tps_, ops, True)
    for a, b in zip(jgot, tgot):
        _leaves_equal(a, b)
    _leaves_equal(jps_.get_model(), tps_.get_model())
    js, ts = jps_.stats(), tps_.stats()
    assert {k: js[k] for k in _COUNTS} == {k: ts[k] for k in _COUNTS}
    assert tps_.recent_staleness() == jps_.recent_staleness()
    assert ts["dup_commits"] == ts["fenced_commits"] == 0


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
@pytest.mark.parametrize("pull_compression", [None, "int8"])
def test_wire_interop_with_the_jax_package(direction, pull_compression):
    """Each package's client against the other's server gives the centers
    and pulls the same-package pair gives, bit for bit."""
    rule = tr.DynSGDMerge()
    ops = [op for op in _script(seed=9) if op[0] != "pull8"]

    def run(server_cls, client_cls, enc):
        ps = server_cls(_center(), rule if server_cls is
                        tps.SocketParameterServer else jr.DynSGDMerge(),
                        num_workers=3)
        ps.initialize()
        ps.start()
        try:
            clients = [client_cls("127.0.0.1", ps.port, w,
                                  pull_compression=pull_compression)
                       for w in range(3)]
            for c in clients:
                c._sock.settimeout(TIMEOUT)
            got = []
            try:
                for kind, w, payload in ops:
                    c = clients[w]
                    if kind == "pull":
                        got.append(c.pull())
                    elif kind.startswith("commit"):
                        body = enc.encode(payload) if kind == "commit8" \
                            else payload
                        c.commit(w, body)
                    else:
                        got.append(c.exchange(w, payload))
            finally:
                for c in clients:
                    c.close()
            return got, ps.get_model(), ps.stats()
        finally:
            ps.stop()

    same = run(tps.SocketParameterServer, tps.ParameterServerClient,
               tcomp.Int8Codec())
    if direction == "jax_client_port_server":
        cross = run(tps.SocketParameterServer, jps.ParameterServerClient,
                    jcomp.Int8Codec())
    else:
        cross = run(jps.SocketParameterServer, tps.ParameterServerClient,
                    tcomp.Int8Codec())
    assert len(same[0]) == len(cross[0])
    for a, b in zip(same[0], cross[0]):
        _leaves_equal(a, b)
    _leaves_equal(same[1], cross[1])
    assert {k: cross[2][k] for k in _COUNTS} == {k: same[2][k]
                                                 for k in _COUNTS}


# -- codecs -------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codecs_match_the_jax_package_bit_for_bit(codec):
    rng = np.random.default_rng(2)
    tree = {"a": {"kernel": rng.normal(size=(33, 17)).astype(np.float32)},
            "small": rng.normal(size=(5,)).astype(np.float32),
            "ids": np.arange(40, dtype=np.int32),
            "zero": np.zeros(64, np.float32)}
    jc, tc = jcomp.resolve_codec(codec), tcomp.resolve_codec(codec)
    jb, tb = jc.encode(tree), tc.encode(tree)
    _leaves_equal(jb, tb)
    _leaves_equal(jcomp.maybe_decode(jb), tcomp.maybe_decode(tb))
    assert tcomp.is_encoded(tb) and not tcomp.is_encoded(tree)
    assert tcomp.maybe_decode(tree) is tree
    assert tcomp.validate_pull_compression("int8") == "int8"
    with pytest.raises(ValueError):
        tcomp.validate_pull_compression("topk")
    with pytest.raises(TypeError, match="f32 and integer"):
        tcomp._resolve_dtype("bfloat16")


def test_worker_error_feedback_telescopes():
    """The worker's commit compression with error feedback: after N
    windows the transmitted deltas sum to the true deltas up to the last
    residual (one quantization step at most)."""
    rng = np.random.default_rng(4)
    w = AsyncWorker(0, torch.device("cpu"), None, None, None, 1, 1, {}, [],
                    threading.Lock(), codec=tcomp.Int8Codec())
    true_sum = np.zeros((64, 16), np.float32)
    sent_sum = np.zeros((64, 16), np.float32)
    for _ in range(20):
        delta = {"k": (rng.normal(size=(64, 16)) * 1e-2).astype(np.float32)}
        true_sum += delta["k"]
        _, sent = w._compress({"k": delta["k"].copy()}, owned=True)
        sent_sum += sent["k"]
    np.testing.assert_allclose(sent_sum + w._resid["k"], true_sum,
                               rtol=0, atol=1e-5)
    step = float(np.max(np.abs(true_sum))) / 127.0
    assert float(np.max(np.abs(w._resid["k"]))) <= step


# -- launch counters under threads ------------------------------------------


def test_launch_counters_are_exact_under_threads():
    """8 threads count 1000 launches each on a kernel wrapper's counter
    (the path every wrapper takes at a launch): the total is exact, and
    the attribute stays the one the chip run reads and resets."""
    fused_adam_step.launches = 0
    threads = [threading.Thread(target=lambda: [
        _build.count_launch(fused_adam_step) for _ in range(1000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert fused_adam_step.launches == 8000
    fused_adam_step.launches = 0


def test_stuck_worker_is_named_not_waited_for(monkeypatch):
    """The trainer joins worker threads with a deadline: a worker that
    finishes no window within its stall limit (0.2 s here) raises naming
    it, while a worker that ends is joined quietly."""
    monkeypatch.setattr(tworkers, "_STALL_FLOOR_S", 0.2)

    class Stamp:
        def __init__(self, wid):
            self.worker_id = wid
            self.progress_t = time.monotonic()
            self.slowest_s = 0.0

    release = threading.Event()
    done = threading.Thread(target=lambda: None, name="w0")
    stuck = threading.Thread(target=release.wait, args=(TIMEOUT,),
                             daemon=True, name="w3")
    done.start()
    stuck.start()
    try:
        tworkers._join_workers([done], [Stamp(0)])
        with pytest.raises(TimeoutError, match="PS worker 3 "):
            tworkers._join_workers([done, stuck], [Stamp(0), Stamp(3)])
    finally:
        release.set()
        _join([stuck])


# -- training through the PS --------------------------------------------------


def blobs(n=2048, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(classes, dim)).astype(np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    x = centers[labels] + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32)
    return x, labels


def _spec():
    return torch_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                     dtype=torch.float32)


def _final_loss(t):
    return float(np.mean(t.history.losses()[-3:]))


_ALGOS = [
    ("ADAG", dict(communication_window=2)),
    ("DOWNPOUR", dict(communication_window=2, learning_rate=0.02)),
    ("AEASGD", dict(communication_window=4, learning_rate=0.05, rho=0.5)),
    ("EAMSGD", dict(communication_window=4, learning_rate=0.05, rho=0.5,
                    momentum=0.8)),
    ("DynSGD", dict(communication_window=2)),
]


@pytest.mark.parametrize("name,kw", _ALGOS, ids=[a for a, _ in _ALGOS])
def test_ps_backend_trainers_learn(name, kw):
    kw = dict(kw)
    kw.setdefault("learning_rate", 0.1)
    t = getattr(trainers, name)(
        _spec(), loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
        num_workers=4, batch_size=32, num_epoch=3, backend="ps",
        device="cpu", **kw)
    params = t.train(Dataset.from_arrays(*blobs()), shuffle=True)
    assert _final_loss(t) < 0.6, f"{name}: {_final_loss(t)}"
    assert {r.get("worker") for r in t.get_history()} == {0, 1, 2, 3}
    assert t.ps_stats_["commits"] == len(t.history.losses())
    assert set(t.ps_stats_["exchange_phases"]) >= {"compute", "fetch",
                                                   "commit"}
    assert all(isinstance(v, torch.Tensor) for v in params.values())


def test_ps_backend_socket_transport_end_to_end(tmp_path):
    t = trainers.ADAG(_spec(), loss="sparse_softmax_cross_entropy",
                      worker_optimizer="sgd", learning_rate=0.1,
                      num_workers=2, batch_size=32, num_epoch=2,
                      communication_window=2, backend="ps",
                      ps_transport="socket", device="cpu",
                      trace_dir=str(tmp_path))
    t.train(Dataset.from_arrays(*blobs(n=1024)), shuffle=True)
    assert _final_loss(t) < 0.6
    s = t.ps_stats_
    assert s["commits"] == s["fused_exchanges"] == 2 * 2 * 8
    assert os.path.exists(t.trace_path_)
    assert not ttrace.enabled()
    import json

    names = {e["name"] for e in json.load(open(t.trace_path_))["traceEvents"]}
    assert {"worker.compute", "worker.fetch", "worker.commit",
            "ps.exchange", "ps.fold"} <= names


@pytest.mark.parametrize("transport", ["inprocess", "socket"])
def test_ps_backend_compression_learns(transport):
    t = trainers.DOWNPOUR(_spec(), loss="sparse_softmax_cross_entropy",
                          worker_optimizer="sgd", learning_rate=0.02,
                          num_workers=4, batch_size=32, num_epoch=3,
                          communication_window=2, backend="ps",
                          ps_transport=transport, compression="int8",
                          pull_compression="int8", device="cpu")
    t.train(Dataset.from_arrays(*blobs()), shuffle=True)
    assert _final_loss(t) < 0.6
    s = t.ps_stats_
    assert s["compressed_pulls"] == s["commits"] + 4
    # int8 both ways: about a quarter of the f32 bytes on the wire
    f32 = 4 * (16 * 32 + 32 + 32 * 4 + 4)
    assert s["bytes_in"] < 0.5 * f32 * s["commits"]


def test_ps_backend_external_ps_host():
    """A trainer whose workers reach a PS another owner started
    (``ps_host``): the owner holds the center and sees every commit."""
    from distkeras_tpu_torch.parallel.merge_rules import ADAGMerge

    spec = _spec()
    init, _ = spec.init_np(0)
    ps = _socket_ps(init, ADAGMerge(), 2)
    try:
        t = trainers.ADAG(spec, loss="sparse_softmax_cross_entropy",
                          worker_optimizer="sgd", learning_rate=0.1,
                          num_workers=2, batch_size=32, num_epoch=1,
                          communication_window=2, backend="ps",
                          ps_transport="socket", ps_host="127.0.0.1",
                          ps_port=ps.port, device="cpu")
        params = t.train(Dataset.from_arrays(*blobs(n=1024)))
        assert ps.stats()["commits"] == 16 and t.ps_stats_ is None
        center = ps.get_model()
        for k, v in params.items():
            np.testing.assert_array_equal(v.numpy(), center[k])
    finally:
        ps.stop()


@pytest.mark.parametrize("name", ["DOWNPOUR", "DynSGD", "AEASGD"])
def test_one_worker_ps_run_matches_the_jax_package(name):
    import dataclasses

    x, y = blobs(n=512)
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    tspec = _spec()
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=1, batch_size=16,
              communication_window=4, num_epoch=2, backend="ps")
    if name == "AEASGD":
        kw["rho"] = 2.0
    jt = getattr(jdk, name)(jspec, **kw)
    jcenter = jt.train(jdata.Dataset.from_arrays(x, y))
    tt = getattr(trainers, name)(tspec, device="cpu", **kw)
    tcenter = tt.train(Dataset.from_arrays(x, y))
    assert len(tt.history.losses()) == 2 * 512 // 64
    np.testing.assert_allclose(tt.history.losses(), jt.history.losses(),
                               rtol=1e-6)
    back = params_to_jax(tcenter, tspec.module)
    for a, b in zip(jax.tree.leaves(jcenter), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


class _RoundRobin:
    """Lets W workers' PS calls through one at a time, in worker order: a
    worker's k-th call is the (k·W + id)-th. Every worker makes the same
    number of calls (a pull, then one exchange a window), so a free-running
    pool becomes one fixed schedule, the same in both packages."""

    def __init__(self, num_workers):
        self.cv = threading.Condition()
        self.pos = 0
        self.num_workers = num_workers
        self.calls: dict[int, int] = {}

    def run(self, worker_id, fn):
        with self.cv:
            mine = self.calls.get(worker_id, 0) * self.num_workers + worker_id
            assert self.cv.wait_for(lambda: self.pos == mine, TIMEOUT)
        try:
            return fn()
        finally:
            with self.cv:
                self.calls[worker_id] = self.calls.get(worker_id, 0) + 1
                self.pos += 1
                self.cv.notify_all()


def _round_robin_bound(base, turn):
    class Bound(base):
        def pull(self, worker_id=None):
            return turn.run(self.worker_id,
                            lambda: base.pull(self, worker_id))

        def commit(self, worker_id, payload, **kw):
            return turn.run(self.worker_id,
                            lambda: base.commit(self, worker_id, payload,
                                                **kw))

        def exchange(self, worker_id, payload, **kw):
            return turn.run(self.worker_id,
                            lambda: base.exchange(self, worker_id, payload,
                                                  **kw))

    return Bound


@pytest.mark.parametrize("name,window", [("DOWNPOUR", 4), ("DOWNPOUR", 1),
                                         ("DynSGD", 4)])
def test_four_worker_ps_run_matches_the_jax_package(name, window,
                                                    monkeypatch):
    """Four Adam workers through the in-process PS, their exchanges taken
    in a fixed round-robin order (so each commit is priced τ = 3 once the
    pool is running), from the same init on the same unshuffled shards:
    the port's losses and center are the JAX package's, within f32
    rounding (losses rtol 1e-5, center atol 1e-5). What several workers
    add to the one-worker run (the shards, concurrent threads, the fold
    under staleness) is then the reference's."""
    import dataclasses

    from distkeras_tpu import workers as jworkers

    monkeypatch.setattr(jworkers, "_BoundPS", _round_robin_bound(
        jworkers._BoundPS, _RoundRobin(4)))
    monkeypatch.setattr(tworkers, "_BoundPS", _round_robin_bound(
        tworkers._BoundPS, _RoundRobin(4)))
    x, y = blobs(n=1024)
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    tspec = _spec()
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="adam",
              learning_rate=1e-3, num_workers=4, batch_size=16,
              communication_window=window, num_epoch=2, backend="ps")
    jt = getattr(jdk, name)(jspec, **kw)
    jcenter = jt.train(jdata.Dataset.from_arrays(x, y))
    tt = getattr(trainers, name)(tspec, device="cpu", **kw)
    tcenter = tt.train(Dataset.from_arrays(x, y))
    assert jt.ps_stats_["commits"] == tt.ps_stats_["commits"] == \
        2 * 1024 // (16 * window)
    order = lambda h: sorted(h.records, key=lambda r: (r["epoch"],
                                                       r["worker"]))
    jl = [r["loss"] for r in order(jt.history)]
    tl = [r["loss"] for r in order(tt.history)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    back = params_to_jax(tcenter, tspec.module)
    for a, b in zip(jax.tree.leaves(jcenter), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kwargs,item", [
    (dict(ps_chain_length=2), "A7.7"),
    (dict(autoscale_target=2), "A7.8"),
    (dict(ps_directory="h:1"), "A7.9"),
    (dict(ps_num_shards=2), "A7.7"),
    (dict(elastic=True), "A7.8"),
    (dict(directory=True), "A7.9"),
    (dict(watch=True), "A13"),
    (dict(ema_decay=0.9), "A8"),
])
def test_later_ps_kwargs_raise_naming_their_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        trainers.DynSGD(_spec(), backend="ps", device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(ps_pipeline_depth=1), dict(ps_transport="shm"),
    dict(ps_transport="native")], ids=["pipelined", "shm", "native"])
def test_ps_kwargs_of_the_transport_slice_train(kwargs):
    """The pipelined exchange and the shm and native transports, once
    refused, now train: four DynSGD workers learn (final loss < 0.6), one
    commit a window a worker."""
    t = trainers.DynSGD(_spec(), loss="sparse_softmax_cross_entropy",
                        worker_optimizer="sgd", learning_rate=0.1,
                        num_workers=4, batch_size=32, num_epoch=3,
                        communication_window=2, backend="ps", device="cpu",
                        **kwargs)
    t.train(Dataset.from_arrays(*blobs()), shuffle=True)
    assert _final_loss(t) < 0.6
    assert t.ps_stats_["commits"] == len(t.history.losses()) == 96


def test_ps_kwarg_validation():
    with pytest.raises(ValueError, match="backend"):
        trainers.ADAG(_spec(), backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="ps_host requires"):
        trainers.ADAG(_spec(), backend="ps", ps_host="h", device="cpu")
    with pytest.raises(ValueError, match="backend='ps' only"):
        trainers.ADAG(_spec(), compression="int8", device="cpu")
    with pytest.raises(ValueError, match="pull_compression"):
        trainers.ADAG(_spec(), backend="ps", pull_compression="topk",
                      device="cpu")


def test_span_recorder_matches_the_jax_package():
    """The same span sequence through both recorders (ring overflow and
    deterministic sampling included) keeps the same events in the same
    order; off, a span is the shared no-op and nothing records."""
    from distkeras_tpu.observability import trace as jtrace

    assert ttrace.span("x") is ttrace._NOOP_SPAN and ttrace.events() == []
    got = []
    for mod in (jtrace, ttrace):
        mod.enable(ring_size=16, sample=0.5)
        try:
            mod.set_corr("w0:x1")
            for i in range(40):
                with mod.span(f"s{i}"):
                    pass
                if i % 7 == 0:
                    mod.instant("mark", corr=f"c{i}")
            mod.counter("tau", 3)
            got.append(([(e["name"], e["corr"], e["cat"])
                         for e in mod.events()], mod._tracer.dropped()))
        finally:
            mod.disable()
    assert got[0] == got[1]
    assert not ttrace.enabled()
