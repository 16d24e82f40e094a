"""The port's serving front door (distkeras_tpu_torch/serving/frontdoor.py and
the engine's ``prefix_cache`` / ``prefill_chunk`` / ``admission="slo"`` /
``swap_params``) held against the JAX package's.

Host structures (the radix tree, the tenant queues, ``summarize_latencies``)
and ``PagedKVCache.copy_slots`` must equal the JAX package's exactly. The
engines: greedy front-door streams and the front door's counters equal the
JAX front-door engine's from the same weights (bridged through
``convert.py``). Within the port, front-door streams (greedy and sampled,
preempted and refilled) are held to the cache-off engine's token for
token, except where the two runs meet a tie: the cache-off engine prefills
through ``prefill_raw`` and the front door through ``paged_extend_rows``,
whose f32 logits differ by ~1.2e-6 on this model. Where two streams
differ, every token of both from the first difference on is judged on its
own context by a full forward: it is that forward's pick (argmax, or the
seeded sample at its position), or moving two logits by ``TIE_F32`` / 2
makes it the pick. One such tie per stream pair passes, no more.
"""

import math
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.serving.frontdoor as jfd
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.serving import GenerationEngine as JGenerationEngine
from distkeras_tpu.serving import PagedKVCache as JPagedKVCache
from distkeras_tpu.serving.scheduler import (
    summarize_latencies as jsummarize_latencies,
)
from distkeras_tpu_torch import networking
from distkeras_tpu_torch.convert import params_from_jax, tensors_from_jax
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.serving import (
    GenerationClient,
    GenerationEngine,
    GenerationServer,
    PagedKVCache,
)
from distkeras_tpu_torch.serving.paged_cache import sample_rows
from distkeras_tpu_torch.serving import frontdoor as tfd
from distkeras_tpu_torch.serving.scheduler import summarize_latencies

VOCAB, MAXLEN, DIM, HEADS, DEPTH = 64, 64, 32, 4, 1
CFG = dict(vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
           pos_embedding="rope", kv_heads=2)
# f32 tie bound on full-forward logits: 10x the largest gap measured
# between the legacy and the chunked prefill's last-position logits on
# this configuration (1.19e-6)
TIE_F32 = 1e-5


@pytest.fixture(scope="module")
def lm():
    """The JAX spec, its weights at seeds 0 and 1, and the port's model
    at seed 0's weights."""
    spec = jtransformer_lm(dtype=jnp.float32, **CFG)
    p0, _ = spec.init_np(0)
    p1, _ = spec.init_np(1)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    params_from_jax(p0, model)
    return spec, p0, p1, model.eval()


def _engine(model, **kw):
    kw = {"max_batch": 4, "block_size": 8, "max_queue": 64, **kw}
    return GenerationEngine(model, device="cpu", **kw)


def _pick(logits, lp, k, sampling):
    """The token a request with ``sampling`` (its ``temperature``,
    ``top_k``, ``top_p``, ``seed``) takes from one logits row at stream
    index ``k``: argmax when greedy, else ``sample_rows`` at key position
    ``lp + k``, where the engine samples it."""
    temp = float(sampling.get("temperature", 0.0))
    if temp <= 0.0:
        return int(torch.argmax(logits))
    top_k, top_p = sampling.get("top_k"), sampling.get("top_p")
    return int(sample_rows(
        logits[None], np.array([temp], np.float32),
        np.array([VOCAB if top_k is None else top_k], np.int64),
        np.array([1.0 if top_p is None else top_p], np.float32),
        np.array([False]), np.array([sampling.get("seed", 0)], np.int64),
        np.array([lp + k], np.int64))[0])


def _ties(model, prompt, toks, j, sampling, label) -> int:
    """Judge ``toks[j:]``, each token on its own context (prompt + the
    tokens before it) by one full forward: the token is the full
    forward's own pick, or a tie — moving its logit up and the pick's
    down by TIE_F32 / 2 each makes it the pick. Returns the ties."""
    lp = len(prompt)
    seq = np.concatenate([np.asarray(prompt), toks]).astype(np.int64)
    with torch.no_grad():
        lg = model(torch.from_numpy(seq[:-1])[None])[0, lp - 1:].float()
    ties = 0
    for k in range(j, len(toks)):
        t = int(toks[k])
        pick = _pick(lg[k], lp, k, sampling)
        if pick == t:
            continue
        nudged = lg[k].clone()
        nudged[t] += TIE_F32 / 2
        nudged[pick] -= TIE_F32 / 2
        assert _pick(nudged, lp, k, sampling) == t, (
            f"{label}: token {k} is {t}, the full forward's {pick}, with a "
            f"logit gap {float(lg[k][pick] - lg[k][t])} beyond TIE_F32 "
            f"{TIE_F32}")
        ties += 1
    return ties


def _agree(model, prompt, got, want, label, **sampling) -> int:
    """``got`` equals ``want`` token for token, or, from their first
    difference on, every token of both streams is judged on its own
    context by :func:`_ties` (``sampling``: the request's knobs). At
    most one tie per stream pair; returns the tie count (0 when equal)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return 0
    j = int(diff[0])
    ties = (_ties(model, prompt, got, j, sampling, f"{label} (got)")
            + _ties(model, prompt, want, j, sampling, f"{label} (want)"))
    assert ties == 1, (
        f"{label}: the streams differ from token {j} on with {ties} ties, "
        f"not one")
    return ties


def test_agree_rejects_a_wrong_token(lm):
    """The stream judge itself: a cache-off stream with one token
    replaced (greedy), or a sampled stream with one token moved to
    another, is not a tie and fails :func:`_agree`; the stream against
    itself passes with no tie."""
    _, _, _, model = lm
    p = np.arange(5, 17, dtype=np.int32)
    for knobs in (dict(), dict(temperature=0.8, top_k=8, seed=3)):
        eng = _engine(model)
        r = eng.submit(p, max_new_tokens=8, **knobs)
        eng.run_until_idle()
        toks = r.result(0)
        assert _agree(model, p, toks, toks, "self", **knobs) == 0
        bad = toks.copy()
        bad[3] = (bad[3] + VOCAB // 2) % VOCAB
        with pytest.raises(AssertionError, match="beyond TIE_F32"):
            _agree(model, p, bad, toks, "wrong token", **knobs)


# -- the radix tree against the JAX one ---------------------------------------

_A = [1, 2, 3, 4, 5, 6, 7, 8]
_RADIX_CASES = {
    # match, insert, release, max_tokens capping, LRU leaf eviction, flush
    "match_insert_release_evict": [
        ("match", "miss", list(range(12)), 12),
        ("insert", "n", list(range(12)), [5, 6, 7]),
        ("release", "n"),
        ("match", "m", list(range(12)), 12),
        ("match", "m2", list(range(12)), 11),
        ("release", "m2"),
        ("evict", 3),
        ("release", "m"),
        ("evict", 1),
        ("flush",),
    ],
    # partial-block divergence: the copy-on-write candidate and its cap
    "cow_partial_block_divergence": [
        ("insert", "n", _A, [3, 4]),
        ("release", "n"),
        ("match", "m", [1, 2, 3, 4, 5, 6, 9, 9], 7),
        ("release", "m"),
        ("match", "m2", [1, 2, 3, 4, 5, 6, 9, 9], 5),
        ("release", "m2"),
        ("match", "m3", [9, 9, 9, 9], 3),
        # two siblings share the same prefix length: the lower block wins
        ("insert", "s", [1, 2, 3, 4, 5, 6, 0, 0], [2, 9]),
        ("release", "s"),
        ("match", "m4", [1, 2, 3, 4, 5, 6, 7, 1], 8),
        ("release", "m4"),
    ],
    # unpinned release raises; insert validates its block count
    "release_unpinned_and_insert_validates": [
        ("insert", "n", [0, 1, 2, 3], [2]),
        ("release", "n"),
        ("release", "n"),
        ("insert", "bad", [0, 1, 2, 3], [1, 2]),
    ],
    # two requests prefilling the same prompt: the twin's block stays
    # private (not adopted)
    "twin_insert": [
        ("insert", "n1", list(range(8)), [3, 4]),
        ("insert", "n2", list(range(8)), [5, 6]),
        ("release", "n1"),
        ("flush",),
    ],
}


def _random_radix_ops(seed, n=120):
    """A seeded sequence over prompts sharing prefixes (two system prompts,
    divergent tails): matches, inserts, releases (some of unpinned
    nodes), evictions and flushes."""
    rng = np.random.default_rng(seed)
    systems = [list(rng.integers(0, 5, 8)) for _ in range(2)]
    ops, names, nb = [], [], 1
    for i in range(n):
        toks = list(systems[int(rng.integers(2))]) + list(
            rng.integers(0, 5, int(rng.integers(0, 10))))
        r = rng.random()
        if r < 0.35:
            ops.append(("match", f"h{i}", toks, int(rng.integers(1, 20))))
            names.append(f"h{i}")
        elif r < 0.6:
            k = len(toks) // 4
            ops.append(("insert", f"h{i}", toks, list(range(nb, nb + k))))
            names.append(f"h{i}")
            nb += k
        elif r < 0.85 and names:
            ops.append(("release", names[int(rng.integers(len(names)))]))
        elif r < 0.95:
            ops.append(("evict", int(rng.integers(1, 4))))
        else:
            ops.append(("flush",))
    return ops


def _drive_radix(mod, ops):
    c = mod.RadixPrefixCache(4)
    held, log = {}, []
    for op in ops:
        kind = op[0]
        try:
            if kind == "match":
                _, name, toks, cap = op
                m = c.match(np.asarray(toks, np.int32), cap)
                held[name] = m.nodes
                log.append((kind, m.blocks, m.cow_node and m.cow_node.block,
                            m.cow_len, m.tokens(4)))
            elif kind == "insert":
                _, name, toks, blocks = op
                new, adopted = c.insert(np.asarray(toks, np.int32), blocks)
                held[name] = new
                log.append((kind, [n.block for n in new], adopted))
            elif kind == "release":
                c.release(held[op[1]])
                log.append(kind)
            elif kind == "evict":
                log.append((kind, c.evict(op[1])))
            else:
                log.append((kind, c.flush()))
        except ValueError as e:
            log.append(("error", str(e)))
        log.append((len(c), c.total_blocks, c.hits, c.misses, c.evictions,
                    c.inserted, sorted((n.block, n.refs, n.last_used)
                                       for n in c._nodes)))
    return log


@pytest.mark.parametrize("case", [*_RADIX_CASES, "random0", "random1"])
def test_radix_tree_equals_jax(case):
    ops = (_RADIX_CASES[case] if case in _RADIX_CASES
           else _random_radix_ops(int(case[-1])))
    want = _drive_radix(jfd, ops)
    assert _drive_radix(tfd, ops) == want
    errors = [e for e in want if isinstance(e, tuple) and e[0] == "error"]
    if case == "release_unpinned_and_insert_validates":
        assert [e[1].split()[0] for e in errors] == ["release", "2"]
    for mod in (jfd, tfd):
        with pytest.raises(ValueError, match="block_size"):
            mod.RadixPrefixCache(0)


def test_radix_chain_keys_equal_jax():
    """The content hash is the pinned blake2b of both packages: the same
    chain keys in every process and in either package."""
    trees = []
    for mod in (jfd, tfd):
        c = mod.RadixPrefixCache(4)
        c.insert(np.arange(12, dtype=np.int32), [1, 2, 3])
        trees.append(sorted(n.key for n in c._nodes) + [c._root.key])
    assert trees[0] == trees[1]


# -- slo_priority and the tenant queues against the JAX ones -------------------


class _R:
    def __init__(self, rid, slo="default", tenant="t"):
        self.id, self.slo_class, self.tenant = rid, slo, tenant


def test_slo_priority_equals_jax():
    labels = [*jfd.SLO_PRIORITY, "mystery", "", "REALTIME"]
    assert tfd.SLO_PRIORITY == jfd.SLO_PRIORITY
    assert [tfd.slo_priority(x) for x in labels] == \
        [jfd.slo_priority(x) for x in labels]


def _tenant_ops(seed, n=150):
    rng = np.random.default_rng(seed)
    classes = ["realtime", "interactive", "default", "batch",
               "best_effort", "mystery"]
    reqs = [_R(f"r{i}", classes[int(rng.integers(len(classes)))],
               f"t{int(rng.integers(3))}") for i in range(n)]
    ops = []
    for i in range(n):
        r = rng.random()
        ops.append(("push" if r < 0.45 else "push_front" if r < 0.55
                    else "pop" if r < 0.8 else "pop_any" if r < 0.9
                    else "remove", i))
    ops.append(("drain", 0))
    return reqs, ops


def _drive_tenants(mod, reqs, ops):
    q = mod.TenantQueues()
    log, pushed = [], []
    for kind, i in ops:
        try:
            if kind in ("push", "push_front"):
                getattr(q, kind)(reqs[i])
                pushed.append(reqs[i])
            elif kind == "pop":
                head = q.candidate()
                if head is not None:
                    q.pop(head)
                log.append(("pop", head and head.id))
            elif kind == "pop_any" and pushed:
                q.pop(pushed[i % len(pushed)])
            elif kind == "remove" and pushed:
                log.append(q.remove(pushed[i % len(pushed)]))
            elif kind == "drain":
                log.append([r.id for r in q.drain()])
        except ValueError as e:
            log.append(("error", str(e)))
        c = q.candidate()
        log.append((len(q), c and c.id, [r.id for r in q]))
    return log


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_tenant_queues_equal_jax(seed):
    if seed is None:   # test_frontdoor.py's sequence
        reqs = [_R("a1", "batch", "A"), _R("a2", "batch", "A"),
                _R("b1", "batch", "B"), _R("rt", "realtime", "C"),
                _R("b2", "batch", "B"), _R("a3", "batch", "A")]
        ops = [("push", 0), ("push", 1), ("push", 2), ("push", 3),
               ("pop", 0), ("pop", 0), ("pop", 0), ("push_front", 4),
               ("push", 5), ("pop_any", 5), ("remove", 1), ("remove", 1),
               ("drain", 0)]
    else:
        reqs, ops = _tenant_ops(seed)
    want = _drive_tenants(jfd, reqs, ops)
    assert _drive_tenants(tfd, reqs, ops) == want


# -- copy_slots and summarize_latencies against the JAX versions ---------------


def test_copy_slots_equals_jax(lm):
    """Sources gathered before the scatter (a destination that is also a
    source reads the old value), padding self-copies of slot 0, every
    layer's pools in place, the same bytes as the JAX cache."""
    spec, _, _, model = lm
    jc = JPagedKVCache(spec.module, 6, 8)
    tc = PagedKVCache(model, 6, 8)
    rng = np.random.default_rng(2)
    pools = [rng.normal(size=tuple(jc.k_pools[0].shape)).astype(np.float32)
             for _ in range(2 * DEPTH)]
    jc.k_pools = tuple(jnp.asarray(p) for p in pools[:DEPTH])
    jc.v_pools = tuple(jnp.asarray(p) for p in pools[DEPTH:])
    for t, p in zip(tc.k_pools + tc.v_pools, pools):
        t.copy_(torch.from_numpy(p))
    ptrs = [t.data_ptr() for t in tc.k_pools + tc.v_pools]
    for src, dst in (([16, 17, 18, 0, 0], [24, 25, 26, 0, 0]),
                     ([8, 9, 10, 11], [9, 10, 11, 12]),
                     ([40, 41, 42, 43, 44, 45, 46, 0], [8] * 1 + [
                         1, 2, 3, 4, 5, 6, 0])):
        jc.copy_slots(src, dst)
        tc.copy_slots(src, dst)
        for j, t in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert [t.data_ptr() for t in tc.k_pools + tc.v_pools] == ptrs
    assert tc.nbytes == jc.nbytes


def _latency_records():
    rng = np.random.default_rng(5)
    return [{"t": float(i) * 0.5, "slo_class": ("a", "b", "c")[i % 3],
             "state": ("done", "done", "done", "cancelled")[i % 4],
             "total_s": float(rng.uniform(0.1, 2.0)),
             "queue_s": None if i % 7 == 0 else float(rng.uniform(0, .1)),
             "prefill_s": None if i % 4 == 0 else float(rng.uniform(0, .1)),
             "decode_s": float(rng.uniform(0, 1.0))} for i in range(31)]


@pytest.mark.parametrize("window_s,now", [
    (None, None), (3.0, None), (3.0, 8.0), (100.0, None), (0.0, 15.0),
    (2.0, 40.0)])
def test_summarize_latencies_window_equals_jax(window_s, now):
    recs = _latency_records()
    got = summarize_latencies(recs, window_s=window_s, now=now)
    assert got == jsummarize_latencies(recs, window_s=window_s, now=now)
    assert summarize_latencies([], window_s=window_s, now=now) == {}


# -- the knobs ----------------------------------------------------------------


def test_frontdoor_validates_knobs(lm):
    _, _, p1, model = lm
    for kw, word in (({"admission": "lifo"}, "admission"),
                     ({"prefill_chunk": 0}, "prefill_chunk")):
        with pytest.raises(ValueError, match=word):
            _engine(model, **kw)
    eng = _engine(model, prefix_cache=True)
    assert eng._frontdoor and eng.stats()["prefix_hit_rate"] == 0.0
    assert not _engine(model)._frontdoor
    for kw in ({"prefill_chunk": 5}, {"admission": "slo"}):
        assert _engine(model, **kw)._frontdoor
    assert _engine(model).prefix_hit_rate() == 0.0
    assert _engine(model).flush_prefix_cache() == 0
    weights = tensors_from_jax(p1, model)
    with pytest.raises(ValueError, match="policy"):
        eng.swap_params(weights, 2, policy="nope")
    with pytest.raises(ValueError, match="missing"):
        eng.swap_params({k: v for k, v in weights.items()
                         if k != "embed.weight"}, 2)
    bad = dict(weights, **{"embed.weight": torch.zeros(VOCAB + 1, DIM)})
    with pytest.raises(ValueError, match="shape"):
        eng.swap_params(bad, 2)
    other = TransformerLM(dtype=torch.float32, device="cpu",
                          **{**CFG, "depth": 2})
    with pytest.raises(ValueError, match="unknown"):
        eng.swap_params(other.state_dict(), 2)
    assert eng.stats()["staged_version"] is None


# -- engines: the port's front door against the JAX front door ----------------


def _jobs(rng, n, sys_len=12, tail=5, max_new=8):
    """test_frontdoor.py's jobs: n requests sharing one system prompt,
    odd ones sampled."""
    system = rng.integers(0, VOCAB, (sys_len,)).astype(np.int32)
    jobs = []
    for i in range(n):
        p = np.concatenate(
            [system, rng.integers(0, VOCAB, (tail,)).astype(np.int32)])
        kw = dict(max_new_tokens=max_new, seed=i)
        if i % 2:
            kw.update(temperature=0.8, top_k=8)
        jobs.append((p, kw))
    return jobs


_COUNTERS = ("prefix_hit_tokens", "prefix_prompt_tokens", "cow_copies",
             "preemptions", "prefills", "admitted", "completed",
             "tokens_generated", "steps", "prefix_cached_blocks",
             "blocks_in_use")
_KNOBS = ({"prefix_cache": True},
          {"prefix_cache": True, "prefill_chunk": 3, "admission": "slo"})


@pytest.mark.parametrize("kw", _KNOBS, ids=["cache", "cache_chunk3_slo"])
def test_frontdoor_greedy_streams_and_counters_equal_jax(lm, kw):
    """test_frontdoor.py's jobs and knob sets through both front doors:
    every greedy stream token for token equal, and the cache's, the
    chunk loop's and admission's counters equal (sampled streams differ
    across packages — jax.random against torch.Generator — but cannot
    move a counter: no EOS, fixed budgets)."""
    spec, p0, _, model = lm
    jobs = _jobs(np.random.default_rng(11), 8)
    jeng = JGenerationEngine(spec, p0, max_batch=4, block_size=8,
                             max_queue=64, **kw)
    teng = _engine(model, **kw)
    jr = [jeng.submit(p, **k) for p, k in jobs]
    tr = [teng.submit(p, **k) for p, k in jobs]
    jeng.run_until_idle()
    teng.run_until_idle()
    for (_, k), a, b in zip(jobs, jr, tr):
        if "temperature" not in k:
            np.testing.assert_array_equal(b.result(0), a.result(0))
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts.get(k) for k in _COUNTERS} == \
        {k: js.get(k) for k in _COUNTERS}
    assert ts["cow_copies"] >= 1 and ts["prefix_hit_tokens"] > 0
    assert ts["prefix_hit_rate"] == js["prefix_hit_rate"] \
        == teng.prefix_hit_rate()


# -- engines: the port's front door against the port's cache-off engine --------


@pytest.mark.parametrize("kw", _KNOBS, ids=["cache", "cache_chunk3_slo"])
def test_frontdoor_streams_equal_cache_off(lm, kw):
    """Greedy and sampled streams of the front door equal the cache-off
    engine's (a difference only at a TIE_F32 tie), zero blocks leaked
    once the radix tree is flushed."""
    _, _, _, model = lm
    jobs = _jobs(np.random.default_rng(11), 8)
    ref = _engine(model)
    want = [ref.submit(p, **k) for p, k in jobs]
    ref.run_until_idle()
    assert ref.stats()["blocks_in_use"] == 0
    eng = _engine(model, **kw)
    got = [eng.submit(p, **k) for p, k in jobs]
    eng.run_until_idle()
    ties = 0
    for (p, k), g, w in zip(jobs, got, want):
        ties += _agree(model, p, g.result(0), w.result(0), f"{kw}", **k)
    assert ties <= 1, f"{ties} of {len(jobs)} stream pairs met a tie"
    s = eng.stats()
    assert s["prefix_hit_rate"] > 0.0 and s["cow_copies"] >= 1
    assert s["blocks_in_use"] == s["prefix_cached_blocks"] > 0
    assert eng.flush_prefix_cache() == s["prefix_cached_blocks"]
    assert eng.stats()["blocks_in_use"] == 0, f"leak under {kw}"


def test_chunked_prefill_long_prompt_interleaves_with_decode(lm):
    """A prompt longer than a chunk feeds over several steps while a
    short request decodes (its stream keeps growing), and both equal the
    cache-off engine; the pad positions of a chunk that runs past maxlen
    are clamped, not an index error."""
    _, _, _, model = lm
    rng = np.random.default_rng(4)
    short = rng.integers(0, VOCAB, (5,)).astype(np.int32)
    long = rng.integers(0, VOCAB, (50,)).astype(np.int32)
    eng = _engine(model, prefill_chunk=24)   # the third chunk ends past 64

    def prefilling(req):
        return req.state == "queued" or any(
            s is not None and s.request is req and s.phase == "prefill"
            for s in eng._slots)

    rs = eng.submit(short, max_new_tokens=12)
    eng.step()
    rl = eng.submit(long, max_new_tokens=8)
    grew = []
    while prefilling(rl):
        before = len(rs.new_tokens)
        eng.step()
        grew.append(len(rs.new_tokens) - before)
    assert grew == [1] * math.ceil(50 / 24)
    eng.run_until_idle()
    ref = _engine(model)
    ws, wl = (ref.submit(short, max_new_tokens=12),
              ref.submit(long, max_new_tokens=8))
    ref.run_until_idle()
    _agree(model, short, rs.result(0), ws.result(0), "short")
    _agree(model, long, rl.result(0), wl.result(0), "long")


# -- preemption by recompute --------------------------------------------------


def _preemption_jobs():
    rng = np.random.default_rng(3)
    longs = [rng.integers(0, VOCAB, (24,)).astype(np.int32)
             for _ in range(3)]
    shorts = [rng.integers(0, VOCAB, (8,)).astype(np.int32)
              for _ in range(2)]
    return longs, shorts


def _run_starved(make, longs, shorts):
    lb = math.ceil((24 + 8) / 8)      # blocks one long row reserves
    eng = make(num_blocks=2 * lb + 1, admission="slo")
    lreqs = [eng.submit(p, max_new_tokens=8, seed=i,
                        slo_class="best_effort", tenant="bulk")
             for i, p in enumerate(longs)]
    for _ in range(3):
        eng.step()
    active = eng.stats()["active"]
    sreqs = [eng.submit(p, max_new_tokens=8, seed=10 + i, temperature=0.7,
                        top_k=8, slo_class="realtime", tenant="rt")
             for i, p in enumerate(shorts)]
    eng.run_until_idle()
    return eng, active, lreqs + sreqs


def test_preemption_by_recompute(lm):
    """test_frontdoor.py's block-starved SLO engine: realtime arrivals
    preempt a running best-effort row; the victim re-prefills prompt +
    generated on re-admission and every stream equals an unstarved FIFO
    engine's. The JAX engine on the same traffic preempts as often and
    serves the same greedy (best-effort) streams."""
    spec, p0, _, model = lm
    longs, shorts = _preemption_jobs()
    eng, active, got = _run_starved(
        lambda **kw: _engine(model, **kw), longs, shorts)
    assert active == 2     # the pool holds two long rows; the third waits
    s = eng.stats()
    assert s["preemptions"] >= 1
    assert s["completed"] == 5 and s["blocks_in_use"] == 0
    ref = _engine(model)
    want = [ref.submit(p, max_new_tokens=8, seed=i,
                       slo_class="best_effort", tenant="bulk")
            for i, p in enumerate(longs)]
    want += [ref.submit(p, max_new_tokens=8, seed=10 + i, temperature=0.7,
                        top_k=8, slo_class="realtime", tenant="rt")
             for i, p in enumerate(shorts)]
    ref.run_until_idle()
    knobs = [dict(seed=i) for i in range(len(longs))] + [
        dict(seed=10 + i, temperature=0.7, top_k=8)
        for i in range(len(shorts))]
    ties = sum(_agree(model, p, g.result(0), w.result(0), "preempted", **k)
               for p, k, g, w in zip(longs + shorts, knobs, got, want))
    assert ties <= 1, f"{ties} of {len(got)} stream pairs met a tie"
    jeng, jactive, jgot = _run_starved(
        lambda **kw: JGenerationEngine(spec, p0, max_batch=4, block_size=8,
                                       max_queue=64, **kw), longs, shorts)
    assert jactive == active
    assert jeng.stats()["preemptions"] == s["preemptions"]
    for g, j in zip(got[:3], jgot[:3]):
        np.testing.assert_array_equal(g.result(0), j.result(0))


@pytest.mark.slow  # randomized stress, as the JAX package's
def test_randomized_churn_refcounts_leaks_and_streams(lm):
    """test_frontdoor.py's churn on the port: seeded admit / preempt /
    cancel / EOS against a small pool with every front-door feature on.
    At every step the ownership invariant holds (allocator.used == Σ
    private + tree), nothing leaks at rest, and every completed stream
    equals the cache-off engine's (ties within TIE_F32)."""
    _, _, _, model = lm
    rng = np.random.default_rng(0)
    system = rng.integers(0, VOCAB, (12,)).astype(np.int32)
    jobs = []
    for i in range(14):
        if rng.random() < 0.6:
            p = np.concatenate(
                [system,
                 rng.integers(0, VOCAB,
                              (int(rng.integers(1, 10)),)).astype(np.int32)])
        else:
            p = rng.integers(0, VOCAB,
                             (int(rng.integers(4, 28)),)).astype(np.int32)
        kw = dict(
            max_new_tokens=int(rng.integers(2, 10)), seed=i,
            slo_class=("realtime", "default", "batch",
                       "best_effort")[int(rng.integers(4))],
            tenant=f"t{int(rng.integers(3))}",
        )
        if rng.random() < 0.5:
            kw.update(temperature=0.9, top_k=8)
        if rng.random() < 0.4:
            kw["eos_id"] = 7
        jobs.append((p, kw))
    eng = _engine(model, num_blocks=24, prefix_cache=True, prefill_chunk=4,
                  admission="slo")
    reqs, pending, cancelled = [], list(jobs), set()
    for _ in range(3000):
        for _ in range(int(rng.integers(1, 4))):
            if pending:
                p, kw = pending.pop(0)
                reqs.append(eng.submit(p, **kw))
        eng.step()
        if rng.random() < 0.25 and reqs:
            j = int(rng.integers(len(reqs)))
            if reqs[j].state in ("queued", "running"):
                eng.cancel(reqs[j])
                cancelled.add(j)
        with eng._lock:
            private = sum(len(s.blocks) for s in eng._slots
                          if s is not None)
            assert eng.allocator.used_blocks == \
                private + len(eng._prefix), "ownership invariant broken"
        if not pending and eng._idle():
            break
    else:
        raise AssertionError("churn never drained")
    s = eng.stats()
    assert s["completed"] + s["cancelled"] == len(jobs)
    assert s["prefix_hit_rate"] > 0.0
    eng.flush_prefix_cache()
    assert eng.allocator.used_blocks == 0, "blocks leaked under churn"
    ref = _engine(model)
    oracle = {j: ref.submit(p, **kw) for j, (p, kw) in enumerate(jobs)
              if j not in cancelled and reqs[j].state == "done"}
    ref.run_until_idle()
    for j, r in oracle.items():
        _agree(model, jobs[j][0], reqs[j].result(0), r.result(0),
               f"request {j}", **jobs[j][1])


@pytest.mark.slow  # sockets + threads under starvation, as the JAX package's
def test_chaos_midstream_kill_and_preemption_storm(lm):
    """test_frontdoor.py's chaos leg on the port: concurrent clients on a
    block-starved prefix-cache + SLO engine, one client killed
    mid-stream while realtime arrivals force preemptions. Every
    surviving stream completes and equals the cache-off engine's; the
    dead client's and the preempted rows' blocks all come back."""
    _, _, _, model = lm
    rng = np.random.default_rng(5)
    longs = [rng.integers(0, VOCAB, (20,)).astype(np.int32)
             for _ in range(4)]
    shorts = [rng.integers(0, VOCAB, (8,)).astype(np.int32)
              for _ in range(3)]
    lb = math.ceil((20 + 16) / 8)
    eng = _engine(model, num_blocks=2 * lb + 1, prefix_cache=True,
                  prefill_chunk=4, admission="slo")
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.start()
    results, errs = {}, []

    def client(i, prompt, max_new, slo, tenant):
        try:
            c = GenerationClient("127.0.0.1", srv.port)
            results[i] = c.generate(prompt, max_new_tokens=max_new,
                                    seed=i, slo_class=slo, tenant=tenant)
            c.close()
        except Exception as e:    # surfaced below
            errs.append((i, e))

    try:
        lts = [threading.Thread(
            target=client, args=(i, p, 16, "best_effort", "bulk"))
            for i, p in enumerate(longs)]
        for t in lts:
            t.start()
        k = networking.connect("127.0.0.1", srv.port)
        networking.send_data(k, {
            "action": "generate", "prompt": np.ones(16, np.int32),
            "max_new_tokens": 24, "slo_class": "best_effort",
            "tenant": "bulk"})
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            s = eng.stats()
            if s["active"] >= 2 and s["blocks_free"] < 2:
                break
            time.sleep(0.01)
        k.close()
        sts = [threading.Thread(
            target=client, args=(10 + i, p, 8, "realtime", "rt"))
            for i, p in enumerate(shorts)]
        for t in sts:
            t.start()
        for t in lts + sts:
            t.join(60)
            assert not t.is_alive()
        assert not errs, errs
        assert len(results) == 7
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            s = eng.stats()
            if s["cancelled"] >= 1 and s["active"] == 0:
                break
            time.sleep(0.02)
        s = eng.stats()
        assert s["completed"] == 7 and s["cancelled"] >= 1
        assert s["preemptions"] >= 1, "the storm never preempted"
        eng.flush_prefix_cache()
        assert eng.stats()["blocks_in_use"] == 0, "chaos leaked blocks"
    finally:
        srv.stop(drain=False, timeout=10)
    ref = _engine(model)
    want = {i: ref.submit(p, max_new_tokens=16, seed=i)
            for i, p in enumerate(longs)}
    want.update({10 + i: ref.submit(p, max_new_tokens=8, seed=10 + i)
                 for i, p in enumerate(shorts)})
    ref.run_until_idle()
    prompts = {**dict(enumerate(longs)),
               **{10 + i: p for i, p in enumerate(shorts)}}
    for i, toks in results.items():
        _agree(model, prompts[i], toks, want[i].result(0), f"client {i}")


# -- the weight swap ----------------------------------------------------------


def _deploy_prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (n,)).astype(np.int32) for n in lengths]


def _fresh_stream(model, weights, prompt, **kw):
    """A fresh port engine's stream at ``weights``."""
    m = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    m.load_state_dict(weights)
    eng = _engine(m, max_batch=1)
    r = eng.submit(prompt, **kw)
    eng.run_until_idle()
    return r.result(0)


@pytest.mark.parametrize("kw", [{}, {"prefix_cache": True}],
                         ids=["fifo", "cache"])
def test_swap_refill_streams_equal_new_version(lm, kw):
    """test_deploy.py's refill oracle on the port: a refill swap mid-batch
    frees every in-flight row and re-prefills it under the new weights;
    every stream (greedy and seeded-sampled) equals a fresh engine at the
    new version, the greedy ones also the JAX engine's refill. A swap
    flushes the radix tree."""
    spec, p0, p1, _ = lm
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    params_from_jax(p0, model)
    w1 = tensors_from_jax(p1, model)
    prompts = _deploy_prompts(29, (8, 13, 6, 11))
    knobs = [dict(max_new_tokens=12), dict(max_new_tokens=12),
             dict(max_new_tokens=12, temperature=0.8, top_k=8, seed=5),
             dict(max_new_tokens=12)]
    eng = _engine(model, max_batch=3, model_version=1, **kw)
    jeng = JGenerationEngine(spec, p0, max_batch=3, block_size=8,
                             model_version=1, **kw)
    reqs = [eng.submit(p, **k) for p, k in zip(prompts, knobs)]
    jreqs = [jeng.submit(p, **k) for p, k in zip(prompts, knobs)]
    for _ in range(3):
        eng.step()
        jeng.step()
    assert all(len(reqs[i].new_tokens) > 0 for i in range(3))
    eng.swap_params(w1, 2, policy="refill")
    jeng.swap_params(p1, 2, policy="refill")
    before = eng.stats()
    assert before["staged_version"] == 2 and before["last_swap"] is None
    if kw:
        assert before["prefix_cached_blocks"] > 0
    eng.step()          # the swap lands at its top, then re-admission
    s = eng.stats()
    assert s["model_version"] == 2 and s["staged_version"] is None
    assert s["last_swap"] == {
        "version": 2, "policy": "refill", "refilled": 3,
        "blocks_flushed": before.get("prefix_cached_blocks", 0),
        "prefix_cached_blocks": 0 if kw else None, "blocks_in_use": 0,
        "queued": 4}
    eng.run_until_idle()
    jeng.run_until_idle()
    ties = 0
    for p, k, r, j in zip(prompts, knobs, reqs, jreqs):
        assert r.state == "done" and r.model_version == 2
        ties += _agree(eng.model, p, r.result(0),
                       _fresh_stream(model, w1, p, **k), "refill", **k)
        if "temperature" not in k:
            np.testing.assert_array_equal(r.result(0), j.result(0))
    assert ties <= 1, f"{ties} of {len(reqs)} stream pairs met a tie"
    s, js = eng.stats(), jeng.stats()
    assert s["swaps"] == 1 and s["refilled"] == js["refilled"] >= 1
    assert s["model_version"] == 2 and s["staged_version"] is None
    eng.flush_prefix_cache()
    assert eng.stats()["blocks_in_use"] == 0


def test_swap_drain_finishes_old_batch_then_swaps(lm):
    """test_deploy.py's drain oracle on the port: the in-flight row
    finishes on the OLD weights, admission holds the door, and the
    queued request runs on the NEW weights after the gate."""
    _, p0, p1, _ = lm
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    params_from_jax(p0, model)
    w0, w1 = tensors_from_jax(p0, model), tensors_from_jax(p1, model)
    pa, pb = _deploy_prompts(31, (9, 7))
    eng = _engine(model, max_batch=2, model_version=1, prefix_cache=True)
    ra = eng.submit(pa, max_new_tokens=10)
    for _ in range(3):
        eng.step()
    eng.swap_params(w1, 2, policy="drain")
    rb = eng.submit(pb, max_new_tokens=10)   # queued behind the gate
    eng.step()
    assert rb.state == "queued" and eng.stats()["model_version"] == 1
    eng.run_until_idle()
    assert ra.model_version == 1 and rb.model_version == 2
    _agree(model, pa, ra.result(0),
           _fresh_stream(model, w0, pa, max_new_tokens=10), "drained")
    _agree(eng.model, pb, rb.result(0),
           _fresh_stream(model, w1, pb, max_new_tokens=10), "after swap")
    s = eng.stats()
    assert s["refilled"] == 0 and s["model_version"] == 2
    assert s["last_swap"]["policy"] == "drain"
    assert s["last_swap"]["refilled"] == 0
    for name, t in model.state_dict().items():   # the caller's module
        torch.testing.assert_close(t, w0[name], rtol=0, atol=0)
    eng.flush_prefix_cache()
    assert eng.stats()["blocks_in_use"] == 0


def test_swap_leaves_a_shared_module_to_the_other_engine(lm):
    """Two engines over one module (as two replicas behind a router): a
    refill swap on one builds that engine a module of its own; the shared
    module keeps its weights, and the other engine, stepped in between,
    serves the old weights throughout."""
    _, p0, p1, _ = lm
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    params_from_jax(p0, model)
    w0, w1 = tensors_from_jax(p0, model), tensors_from_jax(p1, model)
    prompts = _deploy_prompts(37, (10, 7))
    a = _engine(model, max_batch=2, model_version=1, prefix_cache=True)
    b = _engine(model, max_batch=2, model_version=1, prefix_cache=True)
    ra = [a.submit(p, max_new_tokens=10) for p in prompts]
    rb = [b.submit(p, max_new_tokens=10) for p in prompts]
    for _ in range(3):
        a.step()
        b.step()
    a.swap_params(w1, 2, policy="refill")
    a.step()
    b.step()
    a.run_until_idle()
    b.run_until_idle()
    assert a.model is not model and b.model is model
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, w0[name], rtol=0, atol=0)
    assert a.stats()["model_version"] == 2
    assert b.stats()["model_version"] == 1 and b.stats()["swaps"] == 0
    for p, x, y in zip(prompts, ra, rb):
        assert x.model_version == 2 and y.model_version == 1
        _agree(a.model, p, x.result(0),
               _fresh_stream(model, w1, p, max_new_tokens=10), "swapped")
        _agree(model, p, y.result(0),
               _fresh_stream(model, w0, p, max_new_tokens=10), "shared")


def test_swap_applies_while_engine_idle(lm):
    """A staged swap does not wait for traffic: the scheduler thread
    applies it on an empty batch (a rollback to a lower version too)."""
    _, p0, p1, _ = lm
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    params_from_jax(p0, model)
    w1 = tensors_from_jax(p1, model)
    eng = _engine(model, max_batch=2, model_version=7)
    eng.start()
    try:
        eng.swap_params(w1, 3, policy="drain")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and eng.stats()["model_version"] != 3:
            time.sleep(0.02)
        assert eng.stats()["model_version"] == 3
        for name, t in eng.model.state_dict().items():
            torch.testing.assert_close(t, w1[name], rtol=0, atol=0)
        assert eng.model is not model
    finally:
        eng.stop(drain=False)


def test_registration_meta_carries_live_version_and_hit_rate(lm):
    """``register_with``'s meta follows the engine: after a swap and a
    warm repeated request the directory entry carries the new
    ``model_version`` and a non-zero ``prefix_hit_rate``."""
    from distkeras_tpu_torch.directory import DirectoryClient, DirectoryServer

    _, p0, p1, _ = lm
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG).eval()
    params_from_jax(p0, model)
    dsrv = DirectoryServer(default_ttl=None)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    srv = GenerationServer(_engine(model, max_batch=2, prefix_cache=True),
                           poll_interval=0.02)
    dc = DirectoryClient(seeds)
    try:
        srv.start()
        srv.register_with(seeds, key="rep", ttl=5.0)
        meta = dc.lookup("serve", "rep")[0]["meta"]
        assert meta == {"model_version": 0, "prefix_hit_rate": 0.0}
        srv.engine.swap_params(tensors_from_jax(p1, model), 5)
        c = GenerationClient("127.0.0.1", srv.port)
        try:
            p = np.arange(20, dtype=np.int32)
            for seed in (0, 1):   # the second matches the first's chain
                c.generate(p, max_new_tokens=2, seed=seed)
        finally:
            c.close()
        srv.register_with(seeds, key="rep", ttl=5.0)   # publish now
        meta = dc.lookup("serve", "rep")[0]["meta"]
        assert meta["model_version"] == 5
        assert meta["prefix_hit_rate"] == srv.engine.prefix_hit_rate() > 0
    finally:
        dc.close()
        srv.stop(drain=False, timeout=10)
        dsrv.stop()


# -- the server and the router --------------------------------------------------


def test_server_accepts_tenant_on_the_wire(lm):
    """``tenant`` rides the wire from ``GenerationClient.generate`` (and a
    raw frame) into ``engine.submit``; the streams equal a local run."""
    _, _, _, model = lm
    eng = _engine(model, admission="slo")
    seen = []
    submit = eng.submit

    def recording(prompt, **kw):
        seen.append((kw.get("tenant"), kw.get("slo_class")))
        return submit(prompt, **kw)

    eng.submit = recording
    srv = GenerationServer(eng, poll_interval=0.02)
    srv.start()
    p = np.arange(9, dtype=np.int32)
    try:
        c = GenerationClient("127.0.0.1", srv.port)
        try:
            got = c.generate(p, max_new_tokens=6, tenant="acme",
                             slo_class="realtime")
        finally:
            c.close()
        raw = networking.connect("127.0.0.1", srv.port)
        try:
            networking.send_data(raw, {"action": "generate", "prompt": p,
                                       "max_new_tokens": 6,
                                       "tenant": "zeta"})
            reply = networking.recv_data(raw)
        finally:
            raw.close()
    finally:
        srv.stop(drain=False, timeout=10)
    assert seen == [("acme", "realtime"), ("zeta", None)]
    ref = _engine(model)
    want = ref.submit(p, max_new_tokens=6)
    ref.run_until_idle()
    _agree(model, p, got, want.result(0), "wire")
    np.testing.assert_array_equal(reply["tokens"], got)


def test_router_sends_repeated_prefix_to_the_warm_replica(lm):
    """test_frontdoor.py's router leg on the port: two replicas with
    ``prefix_cache=True``, one warmed; with ``hit_affinity`` the router
    weighs the ring by the advertised hit rates, and a prefix the
    unweighted ring gives the cold replica now goes, every repeat, to
    the warm one, whose cache serves it."""
    from distkeras_tpu_torch.directory import (
        DirectoryServer,
        RoutedGenerationClient,
    )

    _, _, _, model = lm
    dsrv = DirectoryServer(default_ttl=None)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    servers, routers = [], []
    try:
        for i in range(2):
            srv = GenerationServer(_engine(model, max_batch=2,
                                           prefix_cache=True),
                                   poll_interval=0.02)
            srv.start()
            srv.register_with(seeds, key=f"rep-{i}", ttl=5.0)
            servers.append(srv)
        warm = servers[1].engine
        p = np.arange(16, dtype=np.int32)
        for s in (0, 1):
            warm.submit(p, max_new_tokens=2, seed=s)
            assert warm.drain(timeout=20)
        assert warm.prefix_hit_rate() > 0.0
        servers[1].register_with(seeds, key="rep-1", ttl=5.0)
        legacy = RoutedGenerationClient(directory=seeds, vnodes=32,
                                        prefix_tokens=8)
        router = RoutedGenerationClient(directory=seeds, vnodes=32,
                                        prefix_tokens=8, hit_affinity=8.0)
        routers += [legacy, router]
        assert router.replica_hit_rates()["rep-1"] > 0.0
        assert router.replica_hit_rates()["rep-0"] == 0.0
        rng = np.random.default_rng(9)
        moved = None
        for _ in range(64):
            prefix = rng.integers(0, VOCAB, (8,)).astype(np.int32)
            if (legacy._route_order(prefix)[0] == "rep-0"
                    and router._route_order(prefix)[0] == "rep-1"):
                moved = prefix
                break
        assert moved is not None, "the weighted ring moved no prefix"
        hits = warm.stats()["prefix_hit_tokens"]
        for i in range(3):
            tail = np.full(12, i, np.int32)
            router.generate(np.concatenate([moved, moved, tail]),
                            max_new_tokens=2)
        assert router.stats()["routed"] == {"rep-1": 3}
        assert warm.stats()["prefix_hit_tokens"] - hits >= 2 * 16
        assert servers[0].engine.stats()["admitted"] == 0
    finally:
        for r in routers:
            r.close()
        for srv in servers:
            srv.stop(drain=False, timeout=10)
        dsrv.stop()
