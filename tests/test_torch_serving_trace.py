"""The serving flight recorder (``GenerationServer(trace=, trace_dir=,
trace_sample=)``, ``trace_path_``) held against the JAX package's
``distkeras_tpu/serving/server.py`` on the CPU.

Both packages serve the same bridged f32 LM (``params_from_jax`` of
``init_np(0)``) to the same greedy requests with a ``trace_dir``: the
streams are equal token for token, and each timeline file holds one
``serve.request``, ``serve.enqueue``, ``serve.queued`` and
``serve.prefill`` span a request, stitched by the request's id. A server
undoes only an enable it made.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.observability import analyze as janalyze
from distkeras_tpu.observability import trace as jtrace
from distkeras_tpu.serving import GenerationClient as JGenerationClient
from distkeras_tpu.serving import GenerationEngine as JGenerationEngine
from distkeras_tpu.serving import GenerationServer as JGenerationServer
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.observability import analyze as tanalyze
from distkeras_tpu_torch.observability import trace as ttrace
from distkeras_tpu_torch.serving import (
    GenerationClient,
    GenerationEngine,
    GenerationServer,
)

CFG = dict(vocab=64, maxlen=64, dim=32, heads=4, depth=2,
           pos_embedding="rope", kv_heads=2)
SPANS = ("serve.request", "serve.enqueue", "serve.queued", "serve.prefill")
NEW = 6


@pytest.fixture(scope="module")
def pair():
    spec = jtransformer_lm(dtype=jnp.float32, **CFG)
    params, _ = spec.init_np(0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    params_from_jax(params, model)
    return spec, params, model.eval()


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, CFG["vocab"], (n,)).astype(np.int32)
            for n in (7, 12, 9)]


def _sides(pair):
    """(server, client class, trace module, analyze module) a package."""
    spec, params, model = pair
    return (
        (lambda **kw: JGenerationServer(
            JGenerationEngine(spec, params, max_batch=4, block_size=8),
            poll_interval=0.02, **kw), JGenerationClient, jtrace, janalyze),
        (lambda **kw: GenerationServer(
            GenerationEngine(model, max_batch=4, block_size=8, device="cpu"),
            poll_interval=0.02, **kw), GenerationClient, ttrace, tanalyze))


def _serve(make, client_cls, **kw):
    srv = make(**kw)
    srv.start()
    try:
        c = client_cls("127.0.0.1", srv.port)
        streams = [np.asarray(c.generate(p, max_new_tokens=NEW))
                   for p in _prompts()]
        c.close()
    finally:
        srv.stop()
    return srv, streams


def test_the_recorder_writes_one_stitched_span_set_a_request(pair,
                                                             tmp_path):
    """``trace_dir=`` arms the recorder for the server's lifetime: the
    streams equal the JAX server's, ``stop()`` writes
    ``serve-trace-<pid>-<ns>.json`` and sets ``trace_path_``, the file
    holds one span of each lifecycle kind a request under one id, the
    analyzer counts the requests served, and the recorder is off again."""
    out = []
    for side, (make, client_cls, trace, analyze) in enumerate(_sides(pair)):
        assert not trace.enabled()
        d = tmp_path / f"side{side}"
        srv, streams = _serve(make, client_cls, trace_dir=str(d))
        assert not trace.enabled()
        path = srv.trace_path_
        assert path is not None and path.startswith(str(d))
        assert path.rsplit("/", 1)[1].startswith("serve-trace-")
        events, _ = analyze.load_trace(path)
        by_req = collections.defaultdict(collections.Counter)
        for e in events:
            if e["name"] in SPANS:
                by_req[e["corr"]][e["name"]] += 1
        assert len(by_req) == len(_prompts())
        for counts in by_req.values():
            assert counts == {n: 1 for n in SPANS}
        report = analyze.analyze_events(events)
        assert report["serving"]["requests"] == len(_prompts())
        out.append(streams)
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)


def test_a_recorder_enabled_before_the_server_stays_enabled(pair, tmp_path):
    """A recorder the caller enabled is the caller's: the server writes
    its file but leaves it on at stop, in both packages. ``trace=True``
    alone records and writes nothing, and turns its own enable off."""
    for side, (make, client_cls, trace, _) in enumerate(_sides(pair)):
        trace.enable()
        try:
            srv, _ = _serve(make, client_cls,
                            trace_dir=str(tmp_path / f"own{side}"))
            assert trace.enabled()
            assert srv.trace_path_ is not None
        finally:
            trace.disable()
        srv, _ = _serve(make, client_cls, trace=True, trace_sample=0.5)
        assert srv.trace_path_ is None and not trace.enabled()
        assert srv.trace_sample == 0.5
