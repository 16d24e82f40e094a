"""The port's serving tier (distkeras_tpu_torch/serving) held against the
JAX package's.

The load-bearing oracle: in f32 on the CPU the port's GenerationEngine emits
greedy streams token-for-token equal to the JAX GenerationEngine's from the
same weights (bridged from ``init_np(0)``), whatever batch the scheduler
mixes each request into. Sampling keys cannot cross frameworks (jax.random
vs torch.Generator), so sampled streams are held to the JAX filter masks on
the same logits and to determinism per seed within the port.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.serving.paged_cache as jpc
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.serving import BlockAllocator as JBlockAllocator
from distkeras_tpu.serving import BlockPoolExhausted as JBlockPoolExhausted
from distkeras_tpu.serving import GenerationEngine as JGenerationEngine
from distkeras_tpu.serving import slot_map as jslot_map
from distkeras_tpu.serving.scheduler import (
    summarize_latencies as jsummarize_latencies,
)
from distkeras_tpu_torch import networking
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.serving import (
    BlockAllocator,
    BlockPoolExhausted,
    GenerationClient,
    GenerationEngine,
    GenerationServer,
    per_row_new_token_counts,
    slot_map,
)
from distkeras_tpu_torch.serving.paged_cache import sample_rows, warp_rows
from distkeras_tpu_torch.serving.scheduler import summarize_latencies

VOCAB, MAXLEN, DIM, HEADS, DEPTH = 64, 64, 32, 4, 2
CFG = dict(vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
           pos_embedding="rope", kv_heads=2)


@pytest.fixture(scope="module")
def pair():
    spec = jtransformer_lm(dtype=jnp.float32, **CFG)
    params, _ = spec.init_np(0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    params_from_jax(params, model)
    return spec, params, model.eval()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (lp,)).astype(np.int32) for lp in lengths]


# -- block allocator and slot map -------------------------------------------


def test_allocator_semantics_equal_jax():
    ops = [("alloc", 3), ("alloc", 5), ("alloc", 1), ("free", 0),
           ("alloc", 2), ("free", 1), ("free", 0), ("alloc", 4),
           ("alloc", 2), ("free", 0), ("free", 0)]
    out = []
    for cls, exhausted in ((JBlockAllocator, JBlockPoolExhausted),
                           (BlockAllocator, BlockPoolExhausted)):
        a = cls(num_blocks=9, block_size=4)
        held, log = [], []
        for op, arg in ops:
            if op == "alloc":
                try:
                    held.append(a.alloc(arg))
                    log.append(tuple(held[-1]))
                except exhausted:
                    log.append("exhausted")
            else:
                blocks = held.pop(min(arg, len(held) - 1))
                a.free(blocks)
                log.append(("freed", tuple(blocks)))
            log.append((a.used_blocks, a.free_blocks, a.high_water))
        with pytest.raises(ValueError, match="double-free"):
            a.free([1, 1])
        out.append(log)
    assert out[0] == out[1]
    assert BlockAllocator(9, 4).capacity == 8
    with pytest.raises(ValueError, match="scratch"):
        BlockAllocator(1, 4)


def test_slot_map_equals_jax():
    tables = np.random.default_rng(0).integers(0, 20, (3, 5)).astype(np.int64)
    np.testing.assert_array_equal(slot_map(tables, 4), jslot_map(tables, 4))


def test_summarize_latencies_equals_jax():
    rng = np.random.default_rng(5)
    recs = [{"t": float(i), "slo_class": ("a", "b")[i % 2],
             "state": ("done", "done", "cancelled")[i % 3],
             "total_s": float(rng.uniform(0.1, 2.0)),
             "queue_s": float(rng.uniform(0, 0.1)),
             "prefill_s": None if i % 4 == 0 else float(rng.uniform(0, .1)),
             "decode_s": float(rng.uniform(0, 1.0))} for i in range(23)]
    got = summarize_latencies(recs)
    assert got == jsummarize_latencies(recs)
    assert set(got) == {"a", "b"} and sum(v["count"] for v in got.values()) \
        == sum(r["state"] == "done" for r in recs)


def test_per_row_new_token_counts():
    toks = np.array([[3, 5, 5, 5], [1, 2, 3, 4], [5, 0, 0, 5]])
    np.testing.assert_array_equal(per_row_new_token_counts(toks, 5),
                                  [2, 4, 1])
    np.testing.assert_array_equal(per_row_new_token_counts(toks, None),
                                  [4, 4, 4])


# -- engine vs the JAX engine -----------------------------------------------


def test_engine_greedy_streams_equal_jax_engine_f32(pair):
    """Same prompts, same weights, same scheduler shape: every greedy
    stream token-for-token equal to the JAX engine's, no leaked blocks,
    and the batch really was continuous (several rows per step)."""
    spec, params, model = pair
    lengths = [8, 13, 16, 5, 24, 9]
    prompts = _prompts(7, lengths)
    jeng = JGenerationEngine(spec, params, max_batch=4, block_size=8)
    teng = GenerationEngine(model, max_batch=4, block_size=8, device="cpu")
    jr = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.result(0), a.result(0))
    s = teng.stats()
    assert s["completed"] == len(lengths) and s["blocks_in_use"] == 0
    assert s["mean_batch_occupancy"] > 1.5
    assert s["tokens_generated"] == 12 * len(lengths)


def test_engine_eos_retires_early(pair):
    _, _, model = pair
    p = np.arange(10, dtype=np.int32) % VOCAB
    eng = GenerationEngine(model, max_batch=2, block_size=8, device="cpu")
    full = eng.submit(p, max_new_tokens=12)
    eng.run_until_idle()
    stream = full.result(0)
    eos = int(stream[4])
    r = eng.submit(p, max_new_tokens=12, eos_id=eos)
    eng.run_until_idle()
    toks = r.result(0)
    assert toks[-1] == eos and len(toks) <= 5
    np.testing.assert_array_equal(toks, stream[:len(toks)])
    assert eng.stats()["blocks_in_use"] == 0


def test_cancel_frees_blocks_midflight(pair):
    _, _, model = pair
    eng = GenerationEngine(model, max_batch=2, block_size=8, device="cpu")
    r1 = eng.submit(np.ones(8, np.int32), max_new_tokens=30)
    r2 = eng.submit(np.ones(8, np.int32), max_new_tokens=5)
    for _ in range(3):
        eng.step()
    assert eng.stats()["blocks_in_use"] > 0
    eng.cancel(r1)
    eng.run_until_idle()
    assert r1.state == "cancelled" and r2.state == "done"
    with pytest.raises(RuntimeError, match="cancelled"):
        r1.result(0)
    assert eng.stats()["blocks_in_use"] == 0


def test_engine_validates_requests(pair):
    _, _, model = pair
    eng = GenerationEngine(model, max_batch=2, block_size=8, device="cpu",
                           max_queue=1)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.ones((2, 3), np.int32))
    with pytest.raises(ValueError, match="maxlen"):
        eng.submit(np.ones(60, np.int32), max_new_tokens=16)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(np.ones(4, np.int32), top_k=0)
    with pytest.raises(ValueError, match="eos_id"):
        eng.submit(np.ones(4, np.int32), eos_id=VOCAB)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(np.full(4, VOCAB, np.int32))
    eng.submit(np.ones(4, np.int32))
    with pytest.raises(networking.ServerBusyError):
        eng.submit(np.ones(4, np.int32))
    with pytest.raises(TypeError, match="TransformerLM"):
        GenerationEngine(object(), device="cpu")


# -- sampling ------------------------------------------------------------------


def _jax_warped(logits, temp, top_k, top_p, greedy):
    """The JAX sample_rows' own filter output: its categorical draw is
    intercepted (through a stand-in for the module's ``jax`` name) and
    handed the warped logits it was about to sample from."""
    seen = []

    def vmap(fn):
        def run(keys, scaled):
            seen.append(np.asarray(scaled))
            return jnp.zeros(scaled.shape[0], jnp.int32)
        return run

    shim = types.SimpleNamespace(nn=jax.nn, random=jax.random, vmap=vmap)
    real = jpc.jax
    jpc.jax = shim
    try:
        jpc.sample_rows(jnp.asarray(logits), jnp.zeros((len(temp), 2),
                                                       jnp.uint32),
                        jnp.asarray(temp), jnp.asarray(top_k),
                        jnp.asarray(top_p), jnp.asarray(greedy))
    finally:
        jpc.jax = real
    return seen[0]


def test_sample_rows_filter_masks_match_jax():
    rng = np.random.default_rng(4)
    V = 50
    logits = rng.normal(size=(6, V)).astype(np.float32) * 3
    logits[5, :4] = logits[5].max() + 1.0        # a tie at the top
    temp = np.array([0.7, 1.0, 1.3, 0.5, 1.0, 0.9], np.float32)
    top_k = np.array([5, V, 12, 1, V, 3], np.int32)
    top_p = np.array([1.0, 0.8, 0.5, 1.0, 0.3, 0.95], np.float32)
    greedy = np.array([False, False, False, False, True, False])
    ref = _jax_warped(logits, temp, top_k, top_p, greedy)
    got = warp_rows(torch.from_numpy(logits), torch.from_numpy(temp),
                    torch.from_numpy(top_k.astype(np.int64)),
                    torch.from_numpy(top_p), torch.from_numpy(greedy))
    np.testing.assert_array_equal(got.numpy() <= -1e29, ref <= -1e29)
    kept = ref > -1e29
    np.testing.assert_allclose(got.numpy()[kept], ref[kept], rtol=1e-6)
    # greedy rows ignore the warp; sampled rows draw only kept tokens
    toks = sample_rows(torch.from_numpy(logits), temp, top_k, top_p, greedy,
                       np.arange(6), np.zeros(6, np.int64)).numpy()
    assert toks[4] == int(np.argmax(logits[4]))
    assert all(kept[b, toks[b]] for b in range(6))


def test_sampled_streams_deterministic_per_seed(pair):
    _, _, model = pair
    p = _prompts(3, [9])[0]
    eng = GenerationEngine(model, max_batch=3, block_size=8, device="cpu")
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=8)
    r1 = eng.submit(p, seed=5, **kw)
    r2 = eng.submit(p, seed=5, **kw)
    r3 = eng.submit(p, seed=6, **kw)
    eng.run_until_idle()
    t1, t2, t3 = r1.result(0), r2.result(0), r3.result(0)
    np.testing.assert_array_equal(t1, t2)   # same seed, different rows
    assert not np.array_equal(t1, t3)
    assert t1.min() >= 0 and t1.max() < VOCAB


# -- socket front end ----------------------------------------------------------


def test_server_answers_concurrent_clients_with_engine_tokens(pair):
    """Two concurrent TCP clients get exactly the tokens a local engine
    run emits for their prompts; a client killed mid-stream has its
    request cancelled and its blocks freed."""
    _, _, model = pair
    prompts = _prompts(11, [7, 12])
    ref = GenerationEngine(model, max_batch=4, block_size=8, device="cpu")
    want = [ref.submit(p, max_new_tokens=8) for p in prompts]
    ref.run_until_idle()
    srv = GenerationServer(GenerationEngine(model, max_batch=4, block_size=8,
                                            device="cpu"),
                           poll_interval=0.02)
    srv.start()
    got, errs = {}, []

    def client(i):
        try:
            c = GenerationClient("127.0.0.1", srv.port)
            got[i] = c.generate(prompts[i], max_new_tokens=8)
            c.close()
        except Exception as e:   # surfaced below
            errs.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        victim = networking.connect("127.0.0.1", srv.port)
        networking.send_data(victim, {"action": "generate",
                                      "prompt": np.ones(8, np.int32),
                                      "max_new_tokens": 40})
        time.sleep(0.05)
        victim.close()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        assert not errs, errs
        for i in range(2):
            np.testing.assert_array_equal(got[i], want[i].result(0))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = srv.stats()
            if s["cancelled"] >= 1 and s["active"] == 0:
                break
            time.sleep(0.02)
        assert s["completed"] == 2 and s["cancelled"] == 1
        assert s["dead_connections"] == 1 and s["blocks_in_use"] == 0
        c = GenerationClient("127.0.0.1", srv.port)
        with pytest.raises(networking.ProtocolError, match="bad_request"):
            c.generate(np.full(4, VOCAB, np.int32))
        assert c.stats()["completed"] == 2
        c.close()
    finally:
        srv.stop()


def test_restricted_unpickler_refuses_globals():
    import pickle

    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        networking.decode_frame(pickle.dumps(threading.Thread))
    frame = pickle.dumps({"tokens": np.arange(3, dtype=np.int32)})
    np.testing.assert_array_equal(networking.decode_frame(frame)["tokens"],
                                  [0, 1, 2])
