"""The port's pipelined exchange (``ps_pipeline_depth=1``) and the lagged
DynSGD pricing it rides on, held against the JAX package on the CPU.

- ``lag=True`` prices τ from the worker's previous pull version, on every
  transport (in-process, socket, shm, native), and the centers and τ are
  the JAX package's bit for bit, also when one package's client drives the
  other's server (tolerance 0: the PS is host numpy, or the same C++ core,
  on both sides);
- one pipelined DOWNPOUR worker is bit-equal to the serial loop (the
  deferred re-base telescopes: ``C_N == C_{N-1} + sent_N`` at fold scale
  1), raw and with int8 commits, on each transport;
- every exchange of the pipelined loop carries ``lag`` and none of the
  serial loop's does, and exchange N is issued after window N+1 launched;
- one pipelined worker trained by each package from the same init gives
  the same losses (rtol 1e-6) and centers (atol 1e-5 in f32, the bound
  ``tests/test_torch_ps.py`` holds the serial PS path to).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu import data as jdata
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models import mlp as jax_mlp
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu_torch import trainers, utils
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch import workers as tworkers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.parallel import merge_rules as tr
from tests.test_torch_ps import TIMEOUT, _spec, blobs


def _jax_native():
    from distkeras_tpu import native_ps as jnative
    from distkeras_tpu.native import load_dkps as jload

    jload(required=True)
    return jnative


def _tnative():
    from distkeras_tpu_torch import native_ps as tnative

    return tnative


def _equal(a, b):
    la, lb = utils.flatten(a)[0], utils.flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- the lag pricing ----------------------------------------------------------


def _lag_script(ps_exchange, ps_pull):
    """The JAX package's lag test: one DynSGD worker's pull, then two
    lagged exchanges of +2: τ 0 then 1 (the previous pull), so +2 then
    +1; unlagged the second would be τ 0, +2."""
    d = {"w": np.array([2.0], np.float32)}
    ps_pull()
    ps_exchange(d, True)
    ps_exchange(d, True)
    ps_exchange(d, False)


class _Transport:
    """One PS of a transport and a client of worker 0 on it."""

    def __init__(self, kind, center, rule):
        self.kind = kind
        if kind == "inprocess":
            self.ps = tps.ParameterServer(center, rule, 1)
            self.client = tworkers._BoundPS(self.ps, 0)
            return
        if kind == "shm":
            from distkeras_tpu_torch.shm import ShmParameterServer, ShmPSClient

            self.ps = ShmParameterServer(center, rule, 1)
            self.ps.initialize()
            self.client = ShmPSClient(self.ps, 0)
            return
        self.ps = (_tnative().NativeSocketParameterServer
                   if kind == "native" else tps.SocketParameterServer)(
            center, rule, 1)
        self.ps.initialize()
        self.ps.start()
        self.client = None

    def connect(self):
        if self.client is not None:
            return self.client
        if self.kind == "native":
            mod = _tnative()
            self.client = mod.NativePSClient("127.0.0.1", self.ps.port, 0,
                                             mod.FlatSpec(self.ps.get_model()))
        else:
            self.client = tps.ParameterServerClient("127.0.0.1",
                                                    self.ps.port, 0)
            self.client._sock.settimeout(TIMEOUT)
        return self.client

    def close(self):
        if self.client is not None and self.kind != "inprocess":
            self.client.close()
        self.ps.stop()


@pytest.mark.parametrize("transport", ["inprocess", "socket", "shm",
                                       "native"])
def test_lag_prices_the_previous_pull_version(transport):
    """``test_exchange.py:88`` on each transport: the center reads
    2 + 1 + 2 (the lagged second exchange priced τ=1), the JAX in-process
    PS's bits, and its τ sequence where the server keeps one."""
    ref = jps.ParameterServer({"w": np.zeros(1, np.float32)},
                              jr.DynSGDMerge(), num_workers=1)
    _lag_script(lambda d, lag: ref.exchange(0, d, lag=lag),
                lambda: ref.pull(0))
    t = _Transport(transport, {"w": np.zeros(1, np.float32)},
                   tr.DynSGDMerge())
    try:
        c = t.connect()
        _lag_script(lambda d, lag: c.exchange(0, d, lag=lag), c.pull)
        np.testing.assert_array_equal(t.ps.get_model()["w"], [5.0])
        _equal(t.ps.get_model(), ref.get_model())
        if transport != "native":
            assert t.ps.recent_staleness() == ref.recent_staleness() \
                == [0, 1, 0]
    finally:
        t.close()


def _lagged_deltas():
    rng = np.random.default_rng(3)
    center = {"b": rng.normal(size=(7,)).astype(np.float32),
              "w": rng.normal(size=(64,)).astype(np.float32)}
    deltas = [{"b": rng.normal(size=(7,)).astype(np.float32) * 0.1,
               "w": rng.normal(size=(64,)).astype(np.float32) * 0.1}
              for _ in range(5)]
    return center, deltas


@pytest.mark.parametrize("transport", ["socket", "native"])
@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_lagged_exchanges_interop_with_the_jax_package(transport, direction):
    """Scripted lagged exchanges (three workers' pulls interleaved, so τ
    moves) from one package's client into the other's server give the
    centers, returned pulls and τ the JAX pair gives, bit for bit."""
    center, deltas = _lagged_deltas()

    def run(server_pkg, client_pkg):
        mod_s = (_tnative() if server_pkg == "torch" else _jax_native()) \
            if transport == "native" else (tps if server_pkg == "torch"
                                           else jps)
        rule = tr.DynSGDMerge() if server_pkg == "torch" \
            else jr.DynSGDMerge()
        server = (mod_s.NativeSocketParameterServer if transport == "native"
                  else mod_s.SocketParameterServer)
        ps = server(center, rule, 3)
        ps.initialize()
        ps.start()
        try:
            mod_c = (_tnative() if client_pkg == "torch" else _jax_native()) \
                if transport == "native" else (tps if client_pkg == "torch"
                                               else jps)
            if transport == "native":
                spec = mod_c.FlatSpec(center)
                cs = [mod_c.NativePSClient("127.0.0.1", ps.port, w, spec)
                      for w in range(3)]
            else:
                cs = [mod_c.ParameterServerClient("127.0.0.1", ps.port, w)
                      for w in range(3)]
            got = [c.pull() for c in cs]
            for k, d in enumerate(deltas):
                got.append(cs[k % 3].exchange(k % 3, d, lag=k % 2 == 0))
            got.append(cs[1].exchange(1, deltas[0]))
            for c in cs:
                c.close()
            taus = (None if transport == "native"
                    else ps.recent_staleness())
            return got, ps.get_model(), taus
        finally:
            ps.stop()

    ref = run("jax", "jax")
    cross = run("torch", "jax") if direction == "jax_client_port_server" \
        else run("jax", "torch")
    for a, b in zip(ref[0], cross[0]):
        _equal(a, b)
    _equal(ref[1], cross[1])
    assert cross[2] == ref[2]
    if transport == "socket":
        assert max(ref[2]) >= 2   # the interleaving made τ move


# -- the pipelined loop -------------------------------------------------------


def _run(name="DOWNPOUR", **kw):
    kw.setdefault("learning_rate", 0.05)
    t = getattr(trainers, name)(
        _spec(), loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
        num_workers=kw.pop("num_workers", 1), batch_size=16,
        communication_window=2, num_epoch=2, backend="ps", device="cpu",
        **kw)
    weights = t.train(Dataset.from_arrays(*blobs(n=512)), shuffle=False)
    return t, {k: v.numpy() for k, v in weights.items()}


@pytest.mark.parametrize("transport,codec", [
    ("inprocess", None), ("inprocess", "int8"), ("socket", None),
    ("shm", None), ("shm", "int8"), ("native", None)])
def test_pipelined_downpour_bit_equal_to_serial(transport, codec):
    """``test_exchange.py:356`` (and ``test_shm.py:265``'s pipelined leg):
    one DOWNPOUR worker's depth-1 run equals its serial run bit for bit,
    raw and with int8 commits."""
    kw = dict(ps_transport=transport, compression=codec)
    t0, w0 = _run(**kw)
    t1, w1 = _run(ps_pipeline_depth=1, **kw)
    _equal(w0, w1)
    assert t0.ps_stats_["commits"] == t1.ps_stats_["commits"] == 32
    np.testing.assert_array_equal(t0.history.losses(), t1.history.losses())


def test_pipelined_exchanges_carry_lag_and_overlap(monkeypatch):
    """``test_exchange.py:373``: every exchange of the pipelined loop
    carries ``lag=True`` and none of the serial loop's does; and the
    pipelined loop issues exchange N only after window N+1 launched."""
    events = []
    orig_exchange = tworkers._BoundPS.exchange
    orig_build = tworkers._build_local_window

    def spy_exchange(self, worker_id, payload, lag=False):
        events.append(("exchange", lag))
        return orig_exchange(self, worker_id, payload, lag=lag)

    def spy_build(loss_step, optimizer):
        window = orig_build(loss_step, optimizer)

        def launch(*args):
            events.append(("launch", None))
            return window(*args)

        launch.init_opt = window.init_opt
        return launch

    monkeypatch.setattr(tworkers._BoundPS, "exchange", spy_exchange)
    monkeypatch.setattr(tworkers, "_build_local_window", spy_build)
    _run("DynSGD", ps_pipeline_depth=1)
    kinds = [k for k, _ in events]
    assert kinds == ["launch"] + ["launch", "exchange"] * 31 + ["exchange"]
    assert all(lag for k, lag in events if k == "exchange")
    events.clear()
    _run("DynSGD")
    assert [k for k, _ in events] == ["launch", "exchange"] * 32
    assert not any(lag for k, lag in events if k == "exchange")


@pytest.mark.parametrize("name", ["DOWNPOUR", "DynSGD"])
def test_one_pipelined_worker_matches_the_jax_package(name):
    """One worker at depth 1 through each package's in-process PS, from
    the same init on the same unshuffled rows: losses within rtol 1e-6,
    centers within atol 1e-5."""
    x, y = blobs(n=512)
    jspec = jax_mlp(input_shape=(16,), hidden=(32,), num_classes=4,
                    dtype=jnp.float32)
    p, _ = jspec.init_np(0)
    tspec = _spec()
    tp = tensors_from_jax(p, tspec.module)
    tspec = dataclasses.replace(tspec, init=lambda seed: (tp, {}))
    kw = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
              learning_rate=0.05, num_workers=1, batch_size=16,
              communication_window=4, num_epoch=2, backend="ps",
              ps_pipeline_depth=1)
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


def test_pipelined_workers_learn_on_every_transport():
    """Four pipelined DynSGD workers learn (final loss < 0.6, the JAX
    package's gate for this data) on each transport, one commit a window
    a worker."""
    for transport in ("inprocess", "socket", "shm", "native"):
        t = trainers.DynSGD(
            _spec(), loss="sparse_softmax_cross_entropy",
            worker_optimizer="sgd", learning_rate=0.1, num_workers=4,
            batch_size=32, communication_window=2, num_epoch=3,
            backend="ps", ps_transport=transport, ps_pipeline_depth=1,
            device="cpu")
        t.train(Dataset.from_arrays(*blobs()), shuffle=True)
        loss = float(np.mean(t.history.losses()[-3:]))
        assert loss < 0.6, (transport, loss)
        assert t.ps_stats_["commits"] == t.ps_stats_["fused_exchanges"] \
            == 4 * 3 * (2048 // 4 // 64)


@pytest.mark.parametrize("name,window", [("DOWNPOUR", 1), ("DynSGD", 4)])
def test_four_pipelined_workers_match_the_jax_package(name, window,
                                                      monkeypatch):
    """Four Adam workers at depth 1 through each package's in-process PS,
    their exchanges taken in one fixed round-robin order (the JAX
    package's and the port's the same schedule), from the same init on
    the same unshuffled shards: losses within rtol 1e-5 and centers
    within atol 1e-5, as ``tests/test_torch_ps.py`` holds the serial loop.
    What free-running pipelined workers learn is then the algorithm's,
    not the port's."""
    from distkeras_tpu import workers as jworkers
    from tests.test_torch_ps import _round_robin_bound, _RoundRobin

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
              communication_window=window, num_epoch=2, backend="ps",
              ps_pipeline_depth=1)
    jt = getattr(jdk, name)(jspec, **kw)
    jcenter = jt.train(jdata.Dataset.from_arrays(x, y))
    tt = getattr(trainers, name)(tspec, device="cpu", **kw)
    tcenter = tt.train(Dataset.from_arrays(x, y))
    assert jt.ps_stats_["commits"] == tt.ps_stats_["commits"] == \
        2 * 1024 // (16 * window)
    order = lambda h: sorted(h.records, key=lambda r: (r["epoch"],
                                                       r["worker"]))
    np.testing.assert_allclose([r["loss"] for r in order(tt.history)],
                               [r["loss"] for r in order(jt.history)],
                               rtol=1e-5)
    back = params_to_jax(tcenter, tspec.module)
    for a, b in zip(jax.tree.leaves(jcenter), jax.tree.leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)
