"""The port's serving clients (distkeras_tpu_torch/serving/server.py):
``ResilientGenerationClient`` across a server crash and restart and under
backpressure, ``GenerationClient.set_timeout``, and each package's client
against the other package's ``GenerationServer`` on the same wire.

Streams are greedy in f32 on the CPU from the same weights
(``convert.params_from_jax``): a replayed request equals the uncrashed
stream token for token, and a cross-package stream equals the serving
package's own engine. Every server and engine a test starts is stopped in
a ``finally``.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.serving import GenerationClient as JGenerationClient
from distkeras_tpu.serving import GenerationEngine as JGenerationEngine
from distkeras_tpu.serving import GenerationServer as JGenerationServer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.networking import ServerBusyError
from distkeras_tpu_torch.resilience.retry import RetryPolicy
from distkeras_tpu_torch.serving import (
    GenerationClient,
    GenerationEngine,
    GenerationServer,
    ResilientGenerationClient,
)

VOCAB = 64
CFG = dict(vocab=VOCAB, maxlen=64, dim=32, heads=4, depth=2, kv_heads=2,
           pos_embedding="rope")
POLICY = dict(max_attempts=60, base_delay=0.02, max_delay=0.2,
              deadline=30.0, seed=0)


@pytest.fixture(scope="module")
def lm():
    spec = jtransformer_lm(dtype=jnp.float32, **CFG)
    params, _ = spec.init_np(0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    params_from_jax(params, model)
    return spec, params, model.eval()


def _prompt(seed, lp):
    return np.random.default_rng(seed).integers(0, VOCAB, (lp,)) \
        .astype(np.int32)


def _engine_stream(model, prompt, max_new):
    eng = GenerationEngine(model, max_batch=2, block_size=8, device="cpu")
    r = eng.submit(prompt, max_new_tokens=max_new)
    eng.run_until_idle()
    return r.result(0)


def _slow(engine, delay):
    """Make every engine step take ``delay`` seconds longer, so a request
    is still in flight when the test crashes its server."""
    step = engine.step

    def slow_step():
        time.sleep(delay)
        return step()

    engine.step = slow_step
    return engine


def test_resilient_client_completes_across_crash_and_restart(lm):
    """One request in flight while its server dies (``_crash``: no drain,
    every connection shut mid-stream) and a new server comes up on the
    same port: the client reconnects, replays, and its stream equals the
    uncrashed one."""
    _, _, model = lm
    prompt, max_new = _prompt(1, 9), 20
    want = _engine_stream(model, prompt, max_new)
    first = GenerationServer(
        _slow(GenerationEngine(model, max_batch=2, block_size=8,
                               device="cpu"), 0.05), poll_interval=0.01)
    first.start()
    port = first.port
    second = None
    out, errors = {}, []
    client = ResilientGenerationClient(
        lambda: GenerationClient("127.0.0.1", port, connect_timeout=2.0),
        RetryPolicy(**POLICY))

    def call():
        try:
            out["tokens"] = client.generate(prompt, max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    th = threading.Thread(target=call)
    try:
        th.start()
        deadline = time.monotonic() + 10
        while first.engine.stats()["active"] < 1:
            assert time.monotonic() < deadline, "request never admitted"
            time.sleep(0.01)
        first._crash()
        time.sleep(0.1)
        second = GenerationServer(
            GenerationEngine(model, max_batch=2, block_size=8,
                             device="cpu"), port=port, poll_interval=0.01)
        second.start()
        th.join(30)
        assert not th.is_alive() and not errors, errors
        np.testing.assert_array_equal(out["tokens"], want)
        assert client.reconnects >= 1 and client.retries >= 1
        assert second.stats()["completed"] == 1
    finally:
        client.close()
        first.stop(drain=False, timeout=2)
        if second is not None:
            second.stop(drain=False, timeout=5)
        th.join(5)


class _BusyThenServe:
    """A client stub: busy ``busy`` times, then a stream."""

    made = 0

    def __init__(self, busy):
        type(self).made += 1
        self.busy = busy
        self.closed = False

    def generate(self, prompt, **kw):
        if self.busy:
            self.busy -= 1
            raise ServerBusyError("admission queue full")
        return np.asarray(prompt, np.int32)[::-1]

    def stats(self):
        return {"ok": True}

    def close(self):
        self.closed = True


class _SaltLog(RetryPolicy):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.salts = []

    def run(self, fn, on_retry=None, salt=0, **kw):
        self.salts.append(salt)
        return super().run(fn, on_retry=on_retry, salt=salt, **kw)


def test_a_crashed_server_releases_its_port_at_once(lm):
    """``_crash`` (and ``stop``) free the listening port before they
    return, with no client reconnecting to wake the accept thread: a
    server restarted on the same port binds."""
    _, _, model = lm
    servers = []
    try:
        for kill in ("_crash", "stop", None):
            port = servers[-1].port if servers else 0
            srv = GenerationServer(GenerationEngine(
                model, max_batch=2, block_size=8, device="cpu"), port=port)
            srv.start()
            servers.append(srv)
            if kill:
                getattr(srv, kill)()
        assert len({s.port for s in servers}) == 1
        client = GenerationClient("127.0.0.1", servers[-1].port)
        try:
            want = _engine_stream(model, _prompt(3, 5), 2)
            got = client.generate(_prompt(3, 5), max_new_tokens=2)
            np.testing.assert_array_equal(got, want)
        finally:
            client.close()
    finally:
        for srv in servers:
            srv.stop()


def test_resilient_client_backs_off_on_busy_and_keeps_the_connection():
    """Backpressure is not a failure: the client backs off and replays on
    the same connection (no reconnect), counting each retry; every call
    salts the policy's jitter with its own count."""
    _BusyThenServe.made = 0
    policy = _SaltLog(**POLICY)
    client = ResilientGenerationClient(lambda: _BusyThenServe(3), policy)
    got = client.generate(np.arange(4, dtype=np.int32))
    np.testing.assert_array_equal(got, [3, 2, 1, 0])
    assert client.retries == 3 and client.reconnects == 0
    assert _BusyThenServe.made == 1 and not client._client.closed
    assert client.stats() == {"ok": True}
    assert policy.salts == [1, 2]


def test_resilient_client_against_a_busy_server(lm):
    """A real server whose queue holds one request: the second client's
    request is refused busy while the first runs, backs off on its open
    connection and completes once the queue drains."""
    _, _, model = lm
    eng = _slow(GenerationEngine(model, max_batch=1, max_queue=1,
                                 block_size=8, device="cpu"), 0.02)
    srv = GenerationServer(eng, poll_interval=0.01)
    srv.start()
    prompts = [_prompt(2, 7), _prompt(3, 6), _prompt(4, 8)]
    clients = [ResilientGenerationClient(
        lambda: GenerationClient("127.0.0.1", srv.port),
        RetryPolicy(**POLICY)) for _ in prompts]
    out, errors = {}, []

    def call(i):
        try:
            out[i] = clients[i].generate(prompts[i], max_new_tokens=10)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors and len(out) == len(prompts), errors
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(out[i],
                                          _engine_stream(model, p, 10))
        assert sum(c.retries for c in clients) >= 1
        assert sum(c.reconnects for c in clients) == 0
        assert srv.stats()["rejected"] >= 1
    finally:
        for c in clients:
            c.close()
        srv.stop(drain=False, timeout=5)


def test_set_timeout_bounds_a_blocked_read(lm):
    _, _, model = lm
    eng = _slow(GenerationEngine(model, max_batch=1, block_size=8,
                                 device="cpu"), 0.2)
    srv = GenerationServer(eng, poll_interval=0.01)
    srv.start()
    client = GenerationClient("127.0.0.1", srv.port)
    try:
        client.set_timeout(0.1)
        with pytest.raises(OSError):   # socket.timeout is an OSError
            client.generate(_prompt(5, 6), max_new_tokens=10)
    finally:
        client.close()
        srv.stop(drain=False, timeout=5)


def test_port_client_against_the_jax_server(lm):
    spec, params, model = lm
    eng = JGenerationEngine(spec, params, max_batch=2, block_size=8)
    srv = JGenerationServer(eng, poll_interval=0.01)
    srv.start()
    client = ResilientGenerationClient(
        lambda: GenerationClient("127.0.0.1", srv.port),
        RetryPolicy(**POLICY))
    try:
        for seed, lp in ((6, 9), (7, 12)):
            p = _prompt(seed, lp)
            got = client.generate(p, max_new_tokens=10)
            np.testing.assert_array_equal(got, _engine_stream(model, p, 10))
        assert client.stats()["completed"] == 2
    finally:
        client.close()
        srv.stop(drain=False, timeout=5)


def test_jax_client_against_the_port_server(lm):
    spec, params, model = lm
    srv = GenerationServer(GenerationEngine(model, max_batch=2, block_size=8,
                                            device="cpu"), poll_interval=0.01)
    srv.start()
    client = JGenerationClient("127.0.0.1", srv.port)
    try:
        jeng = JGenerationEngine(spec, params, max_batch=2, block_size=8)
        for seed, lp in ((8, 7), (9, 13)):
            p = _prompt(seed, lp)
            got = client.generate(p, max_new_tokens=10)
            want = jeng.submit(p, max_new_tokens=10)
            jeng.run_until_idle()
            np.testing.assert_array_equal(got, want.result(0))
        assert client.stats()["completed"] == 2
    finally:
        client.close()
        srv.stop(drain=False, timeout=5)
