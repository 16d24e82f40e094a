"""Speculative decoding on the port held against the JAX package's: the
dense ``speculative_generate`` (distkeras_tpu_torch/models/lm.py) and the
engine's speculative serving (``GenerationEngine(draft=, spec_tokens=)``).

In f32 on the CPU, from the same weights (``convert.params_from_jax``) and
the same numpy-seeded prompts: greedy tokens and the ``rounds`` /
``proposed`` / ``accepted`` stats equal the JAX package's exactly (ties
have measure zero in f32) with an unrelated draft, and on the JAX
package's own test LM drafting itself. With a self-draft the port accepts
every proposal on the rope/GQA target too, where the JAX package's dense
path, which leaves a hole in its draft's cache, accepts less. Sampled speculation cannot cross frameworks (jax.random
against torch.Generator); it is held to determinism per seed, to greedy
at top_k=1, to full acceptance with a self-draft, and to the target's
distribution: the token histogram against plain sampled ``generate``
within total variation 0.08, the JAX package's gate
(``tests/test_generation.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgenerate
from distkeras_tpu.models import speculative_generate as jspeculative
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.serving import GenerationEngine as JGenerationEngine
from distkeras_tpu_torch.convert import params_from_jax, tensors_from_jax
from distkeras_tpu_torch.models import generate, speculative_generate
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.serving import GenerationEngine

VOCAB, MAXLEN = 64, 48
TARGET = dict(vocab=VOCAB, maxlen=MAXLEN, dim=32, heads=4, depth=2,
              kv_heads=2, pos_embedding="rope")
DRAFT = dict(vocab=VOCAB, maxlen=MAXLEN, dim=16, heads=2, depth=1,
             kv_heads=1, pos_embedding="rope")
SPEC_STATS = ("spec_rounds", "spec_proposed", "spec_accepted",
              "spec_acceptance")


def _pair(cfg, seed):
    spec = jtransformer_lm(dtype=jnp.float32, **cfg)
    params, _ = spec.init_np(seed)
    model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    params_from_jax(params, model)
    return spec, params, model.eval()


@pytest.fixture(scope="module")
def models():
    """(target spec, params, port target), (draft spec, params, port
    draft): an unrelated draft from another seed and width."""
    return _pair(TARGET, 0), _pair(DRAFT, 99)


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape) \
        .astype(np.int32)


# -- dense speculative_generate ------------------------------------------------


@pytest.mark.parametrize("draft,K,new", [
    ("unrelated", 3, 11), ("self", 3, 12), ("self", 4, 9),
    ("unrelated", 1, 7)], ids=["unrelated-K3", "self-K3",
                               "self-K4-overhang", "unrelated-K1"])
def test_greedy_speculative_equals_jax_tokens_and_stats(models, draft, K,
                                                        new):
    (ts, tp, tm), (ds, dp, dm) = models
    if draft == "self":
        ds, dp, dm = ts, tp, tm
    prompt = _prompts(1, (3, 6))
    want, wstats = jspeculative(ts, tp, ds, dp, prompt, new, spec_tokens=K)
    got, stats = speculative_generate(tm, dm, prompt, new, spec_tokens=K)
    assert got.dtype == np.int32 and got.shape == (3, 6 + new)
    np.testing.assert_array_equal(got, want)
    wstats = {k: (int(v) if k != "acceptance" else v)
              for k, v in wstats.items()}
    if draft == "self":
        # every proposal stands, K+1 tokens a verify pass; the JAX
        # package's draft skips the (K+1)-th step, so after its first
        # fully accepted round it attends to an unwritten cache position
        # and accepts less (ROADMAP.md queue C)
        assert stats["accepted"] == stats["proposed"]
        assert stats["acceptance"] == 1.0 > wstats["acceptance"]
        assert stats["rounds"] == -(-(new - 1) // (K + 1)) < wstats["rounds"]
    else:
        # no round of the unrelated draft is fully accepted, so the extra
        # draft step changes nothing the stats count
        assert stats == wstats
    # exactness: the target's own greedy stream, whatever the draft
    np.testing.assert_array_equal(got, generate(tm, prompt, new))


@pytest.fixture(scope="module")
def mha():
    """The JAX package's own generation-test LM (sincos, MHA)."""
    return _pair(dict(vocab=VOCAB, maxlen=32, dim=32, heads=4, depth=2), 0)


def test_greedy_self_draft_accepts_everything(mha, models):
    """With the target as its own draft every proposal stands (K+1 tokens
    a verify pass), on the JAX package's test LM in both packages, and on
    the rope/GQA target in the port alone: the JAX package's dense path
    runs K draft steps a round, so a fully accepted round leaves its
    draft's cache unwritten at position p+K (ROADMAP.md queue C); the
    port's (K+1)-th draft step, as in both engines, writes it."""
    ts, tp, tm = mha
    prompt = np.ones((2, 5), np.int32)
    new, K = 12, 3
    out, stats = speculative_generate(tm, tm, prompt, new, spec_tokens=K)
    np.testing.assert_array_equal(out, jgenerate(ts, tp, prompt, new))
    _, want = jspeculative(ts, tp, ts, tp, prompt, new, spec_tokens=K)
    assert stats == {k: (int(v) if k != "acceptance" else v)
                     for k, v in want.items()}
    assert stats["accepted"] == stats["proposed"]
    assert stats["acceptance"] == 1.0
    assert stats["rounds"] == -(-(new - 1) // (K + 1))
    (ts, tp, tm), _ = models
    _, want = jspeculative(ts, tp, ts, tp, prompt, new, spec_tokens=K)
    _, got = speculative_generate(tm, tm, prompt, new, spec_tokens=K)
    assert got["acceptance"] == 1.0 > float(want["acceptance"])
    assert got["rounds"] == -(-(new - 1) // (K + 1)) < int(want["rounds"])


def test_sampled_speculative_reproducible_and_valid(models):
    (_, _, tm), (_, _, dm) = models
    prompt = _prompts(2, (3, 5))
    kw = dict(spec_tokens=3, temperature=1.0)
    a, sa = speculative_generate(tm, dm, prompt, 8, seed=5, **kw)
    b, sb = speculative_generate(tm, dm, prompt, 8, seed=5, **kw)
    c, _ = speculative_generate(tm, dm, prompt, 8, seed=6, **kw)
    np.testing.assert_array_equal(a, b)
    assert sa == sb
    assert not np.array_equal(a, c)
    assert a.shape == (3, 13) and a.min() >= 0 and a.max() < VOCAB
    np.testing.assert_array_equal(a[:, :5], prompt)
    assert 0 <= sa["accepted"] <= sa["proposed"] <= 3 * 3 * sa["rounds"]


def test_sampled_top_k_1_degenerates_to_greedy(models):
    (_, _, tm), (_, _, dm) = models
    prompt = _prompts(3, (2, 6))
    out, _ = speculative_generate(tm, dm, prompt, 9, spec_tokens=3,
                                  temperature=2.0, top_k=1, seed=11)
    np.testing.assert_array_equal(out, generate(tm, prompt, 9))


def test_sampled_self_draft_accepts_everything(mha):
    """draft == target: p == q up to the decode/verify programs' f32
    rounding, so every proposal stands but for a measure-zero draw (a
    truncating warp may flip a boundary token, hence the bound below 1)."""
    _, _, tm = mha
    prompt = np.ones((2, 5), np.int32)
    _, stats = speculative_generate(tm, tm, prompt, 12, spec_tokens=3,
                                    temperature=1.3, seed=2)
    assert stats["acceptance"] >= 0.95
    _, stats = speculative_generate(tm, tm, prompt, 12, spec_tokens=3,
                                    temperature=1.3, top_k=8, top_p=0.9,
                                    seed=2)
    assert stats["acceptance"] >= 0.8


def test_sampled_speculative_preserves_the_target_distribution():
    """Leviathan's guarantee, measured as the JAX package measures it:
    the token histogram of sampled speculation matches plain sampled
    ``generate`` on the same target over seeds × rows × positions."""
    V = 16
    target = TransformerLM(vocab=V, maxlen=16, dim=16, heads=2, depth=1,
                           dtype=torch.float32, device="cpu")
    draft = TransformerLM(vocab=V, maxlen=16, dim=8, heads=2, depth=1,
                          dtype=torch.float32, device="cpu")
    target.reset_parameters(torch.Generator().manual_seed(0))
    draft.reset_parameters(torch.Generator().manual_seed(1))
    B, new, seeds = 64, 6, 12
    prompt = np.zeros((B, 2), np.int32)
    h_plain, h_spec = np.zeros(V), np.zeros(V)
    for s in range(seeds):
        g = generate(target, prompt, new, temperature=1.5, seed=1000 + s)
        h_plain += np.bincount(g[:, 2:].ravel(), minlength=V)
        o, _ = speculative_generate(target, draft, prompt, new,
                                    spec_tokens=3, temperature=1.5,
                                    seed=2000 + s)
        h_spec += np.bincount(o[:, 2:].ravel(), minlength=V)
    n = h_plain.sum()
    assert n == h_spec.sum() == B * new * seeds
    tv = 0.5 * np.abs(h_plain / n - h_spec / n).sum()
    assert tv < 0.08, f"token distributions diverge: TV={tv:.3f}"


# -- the engine's speculative serving ------------------------------------------


def _run(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_idle()
    return [r.result(0) for r in reqs]


@pytest.mark.parametrize("draft", ["self", "unrelated"])
def test_engine_spec_streams_and_counters_equal_jax(models, draft):
    """Greedy speculative serving: every stream and the four ``spec_*``
    counters equal the JAX engine's, rows advancing by their own accepted
    length; the streams equal the target's dense greedy ``generate``. A
    self-draft accepts every proposal across fully accepted rounds (the
    extra draft step closes the draft cache's hole at p+K)."""
    (ts, tp, tm), (ds, dp, dm) = models
    if draft == "self":
        ds, dp, dm = ts, tp, tm
    prompts = [_prompts(10 + i, (lp,)) for i, lp in
               enumerate((8, 11, 16, 5, 9))]
    kw = dict(spec_tokens=3, max_batch=3, block_size=8)
    jeng = JGenerationEngine(ts, tp, draft=ds, draft_params=dp, **kw)
    eng = GenerationEngine(tm, draft=dm, device="cpu", **kw)
    want = _run(jeng, prompts, 12)
    got = _run(eng, prompts, 12)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, generate(tm, p[None], 12)[0, len(p):])
    s, js = eng.stats(), jeng.stats()
    assert {k: s[k] for k in SPEC_STATS} == {k: js[k] for k in SPEC_STATS}
    assert s["steps"] == js["steps"] and s["blocks_in_use"] == 0
    if draft == "self":
        assert s["spec_acceptance"] == 1.0
        assert s["spec_rounds"] < 12 * len(prompts) / 3


def test_engine_spec_refusals(models):
    (_, _, tm), (_, _, dm) = models
    windowed = TransformerLM(dtype=torch.float32, device="cpu",
                             **{**TARGET, "attn_window": 8}).eval()
    other = TransformerLM(dtype=torch.float32, device="cpu",
                          **{**DRAFT, "vocab": 32}).eval()
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 8},
               {"admission": "slo"}):
        with pytest.raises(ValueError, match="draft model"):
            GenerationEngine(tm, draft=dm, device="cpu", **kw)
    with pytest.raises(ValueError, match="spec_tokens"):
        GenerationEngine(tm, draft=dm, spec_tokens=0, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        GenerationEngine(windowed, draft=dm, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        GenerationEngine(tm, draft=windowed, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        GenerationEngine(tm, draft=other, device="cpu")
    with pytest.raises(TypeError, match="draft must be a TransformerLM"):
        GenerationEngine(tm, draft=object(), device="cpu")
    eng = GenerationEngine(tm, draft=dm, device="cpu")
    for kw in ({"temperature": 0.5}, {"top_k": 4}, {"top_p": 0.9}):
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit(np.ones(6, np.int32), **kw)
    with pytest.raises(ValueError, match="draft_weights"):
        GenerationEngine(tm, device="cpu").swap_params(
            tm.state_dict(), 1, draft_weights=dm.state_dict())


def test_engine_spec_block_budget_counts_spec_tokens(models):
    """A request's blocks and maxlen check count ``spec_tokens`` past its
    last token (the verify block probes them), as the JAX engine's."""
    (ts, tp, tm), (ds, dp, dm) = models
    K, bs = 4, 8
    eng = GenerationEngine(tm, draft=dm, spec_tokens=K, block_size=bs,
                           max_batch=2, device="cpu")
    jeng = JGenerationEngine(ts, tp, draft=ds, draft_params=dp,
                             spec_tokens=K, block_size=bs, max_batch=2)
    assert eng._blocks_needed(10, 6) == jeng._blocks_needed(10, 6) == 3
    plain = GenerationEngine(tm, block_size=bs, max_batch=2, device="cpu")
    assert plain._blocks_needed(10, 6) == 2
    with pytest.raises(ValueError, match="spec_tokens 4"):
        eng.submit(np.ones(40, np.int32), max_new_tokens=6)
    plain.submit(np.ones(40, np.int32), max_new_tokens=6)   # fits without
    r = eng.submit(np.ones(10, np.int32), max_new_tokens=6)
    eng.step()
    assert eng.stats()["blocks_in_use"] == 3
    eng.run_until_idle()
    assert r.state == "done" and eng.stats()["blocks_in_use"] == 0


def test_engine_spec_swap_refill_with_draft_weights(models):
    """A refill swap with ``draft_weights`` lands both models at the top
    of a step; every re-served stream equals a fresh speculative engine
    built at the new weights, and the caller's modules are never
    written."""
    (ts, tp, tm), (ds, dp, dm) = models
    p1, _ = ts.init_np(1)
    d1, _ = ds.init_np(2)
    w1, dw1 = tensors_from_jax(p1, tm), tensors_from_jax(d1, dm)
    t_before = {k: v.clone() for k, v in tm.state_dict().items()}
    d_before = {k: v.clone() for k, v in dm.state_dict().items()}
    prompts = [_prompts(20 + i, (lp,)) for i, lp in enumerate((9, 6, 12))]
    eng = GenerationEngine(tm, draft=dm, spec_tokens=3, max_batch=3,
                           block_size=8, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    for _ in range(2):
        eng.step()
    assert all(len(r.new_tokens) > 0 for r in reqs)
    eng.swap_params(w1, 2, policy="refill", draft_weights=dw1)
    eng.run_until_idle()
    s = eng.stats()
    assert s["refilled"] == 3 and s["model_version"] == 2
    assert eng.model is not tm and eng.draft is not dm
    for k, v in tm.state_dict().items():
        assert torch.equal(v, t_before[k])
    for k, v in dm.state_dict().items():
        assert torch.equal(v, d_before[k])
    fresh_t = TransformerLM(dtype=torch.float32, device="cpu", **TARGET)
    fresh_d = TransformerLM(dtype=torch.float32, device="cpu", **DRAFT)
    fresh_t.load_state_dict(w1)
    fresh_d.load_state_dict(dw1)
    fresh = GenerationEngine(fresh_t.eval(), draft=fresh_d.eval(),
                             spec_tokens=3, max_batch=3, block_size=8,
                             device="cpu")
    want = _run(fresh, prompts, 12)
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.result(0), w)
    fs = fresh.stats()
    assert s["spec_accepted"] - fs["spec_accepted"] >= 0
