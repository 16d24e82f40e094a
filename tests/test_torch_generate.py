"""The port's dense-cache decoding (distkeras_tpu_torch/models/lm.py:
``prefill``/``decode_step``/``extend``, the ring cache, ``generate``,
``beam_search``, the warps) and ``predictors.GeneratorPredictor`` held
against the JAX package's.

Weights come from the JAX spec's ``init_np`` and cross through
``convert.params_from_jax``; both sides run in f32 on the CPU on the same
numpy-seeded prompts. Logits agree within 2e-4 (f32 summation order
through a few layers, the JAX package's own decode-vs-forward bound);
greedy and beam tokens are equal (ties have measure zero in f32), beam
scores within 1e-5. Sampled streams cannot cross frameworks (jax.random
against torch.Generator), so they are held to the JAX warp masks on the
same logits, to determinism per seed and to the warped support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JDataset
from distkeras_tpu.models import beam_search as jbeam_search
from distkeras_tpu.models import generate as jgenerate
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.models.lm import TransformerLM as JLM
from distkeras_tpu.models.lm import _warp_fn as jwarp_fn
from distkeras_tpu.predictors import GeneratorPredictor as JGeneratorPredictor
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (
    beam_search,
    generate,
    speculative_generate,
)
from distkeras_tpu_torch.models.lm import TransformerLM, _warp_fn
from distkeras_tpu_torch.predictors import GeneratorPredictor

VOCAB, MAXLEN = 64, 32
BASE = dict(vocab=VOCAB, maxlen=MAXLEN, dim=32, heads=4, depth=2)
ATOL = 2e-4
SCORE_ATOL = 1e-5


def _pair(seed=0, **cfg):
    """(JAX spec, its params, the port's model at the same weights)."""
    cfg = {**BASE, **cfg}
    spec = jtransformer_lm(dtype=jnp.float32, **cfg)
    params, _ = spec.init_np(seed)
    model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    params_from_jax(params, model)
    return spec, params, model.eval()


@pytest.fixture(scope="module")
def lm():
    return _pair(pos_embedding="rope", kv_heads=2)


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape) \
        .astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# -- the dense and ring cache --------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(),                                              # sincos, MHA
    dict(pos_embedding="rope", kv_heads=2),              # rope, GQA
    dict(pos_embedding="rope", kv_heads=1, tie_embeddings=True),  # MQA, tied
], ids=["sincos-mha", "rope-gqa", "rope-mqa-tied"])
def test_decode_step_and_extend_match_full_forward_and_jax(cfg):
    """Prefill + one ``decode_step`` a position equals one full forward
    position by position and the JAX package's decode logits and caches;
    ``extend`` over the same positions equals the sequential steps (the
    verify forward is the T-token decode)."""
    spec, params, model = _pair(**cfg)
    apply = lambda *a, **k: spec.module.apply({"params": params}, *a, **k)  # noqa
    toks = _prompts(1, (3, 14))
    lp = 5
    with torch.no_grad():
        full = model(_t(toks)).numpy()
        logits, caches = model.prefill(_t(toks[:, :lp]))
        jlogits, jcaches = apply(jnp.asarray(toks[:, :lp]),
                                 method=JLM.prefill)
        np.testing.assert_allclose(logits.numpy(), full[:, :lp], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        for (k, v), (jk, jv) in zip(caches, jcaches):
            assert tuple(k.shape) == tuple(jk.shape)
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL,
                                       rtol=0)
        _, ext_caches = model.prefill(_t(toks[:, :lp]))
        jdecode = jax.jit(lambda tok, c, pos: apply(tok, c, pos,
                                                    method=JLM.decode_step))
        steps = []
        for pos in range(lp, toks.shape[1]):
            step, caches = model.decode_step(_t(toks[:, pos]), caches, pos)
            jstep, jcaches = jdecode(jnp.asarray(toks[:, pos]), jcaches, pos)
            np.testing.assert_allclose(step.numpy(), full[:, pos],
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                                       atol=ATOL, rtol=0)
            steps.append(step)
        ext, ext_caches = model.extend(_t(toks[:, lp:]), ext_caches, lp)
        np.testing.assert_allclose(ext.numpy(),
                                   torch.stack(steps, 1).numpy(),
                                   atol=ATOL, rtol=0)
        for (a, b), (c, d) in zip(ext_caches, caches):
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(b.numpy(), d.numpy(), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("lp", [4, 10], ids=["short", "past-window"])
def test_ring_cache_matches_full_forward_and_jax(lp):
    """A sliding-window model keeps a ring of ``window`` slots: the prefill
    seeds it with the last ``window`` prompt positions (a prompt longer
    than the window wraps), never-written slots are masked, and cached
    decode equals the full windowed forward and the JAX ring."""
    window = 6
    spec, params, model = _pair(attn_window=window, pos_embedding="rope",
                                kv_heads=2)
    apply = lambda *a, **k: spec.module.apply({"params": params}, *a, **k)  # noqa
    toks = _prompts(2, (2, 16))
    with torch.no_grad():
        full = model(_t(toks)).numpy()
        _, caches = model.prefill(_t(toks[:, :lp]))
        _, jcaches = apply(jnp.asarray(toks[:, :lp]), method=JLM.prefill)
        assert caches[0][0].shape[1] == window
        for (k, v), (jk, jv) in zip(caches, jcaches):
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL,
                                       rtol=0)
        for pos in range(lp, toks.shape[1]):
            step, caches = model.decode_step(_t(toks[:, pos]), caches, pos)
            np.testing.assert_allclose(step.numpy(), full[:, pos],
                                       atol=ATOL, rtol=0,
                                       err_msg=f"pos={pos}")
        with pytest.raises(ValueError, match="full-length cache"):
            model.extend(_t(toks[:, :2]), caches, 3)


# -- generate ------------------------------------------------------------------


@pytest.mark.parametrize("eos_id", [None, 9], ids=["no-eos", "eos"])
def test_greedy_generate_equals_jax(lm, eos_id):
    spec, params, model = lm
    prompt = _prompts(3, (3, 6))
    if eos_id is not None:
        # an eos the greedy streams do emit, so rows stop and pad
        eos_id = int(jgenerate(spec, params, prompt, 10)[0, 8])
    want = jgenerate(spec, params, prompt, 10, eos_id=eos_id)
    got = generate(model, prompt, 10, eos_id=eos_id)
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_equals_the_full_forward_argmax(lm):
    _, _, model = lm
    prompt = _prompts(4, (2, 5))
    out = generate(model, prompt, 8)
    with torch.no_grad():
        lg = model(_t(out[:, :-1]))
    np.testing.assert_array_equal(lg[:, 4:].argmax(-1).numpy(), out[:, 5:])


def _tied_logits():
    """Logits with exact ties at the top-k and nucleus cutoffs."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 24)).astype(np.float32)
    x[0, [3, 7, 11]] = x[0].max() + 1.0          # a 3-way tie at the top
    x[1, :] = 0.5                                  # all tied
    x[2, [1, 2]] = 2.0                             # tie at the k=2 cutoff
    x[2, 3] = 3.0
    x[3, [4, 5, 6, 7]] = 1.25                      # tie inside the nucleus
    return x


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 2, None), (1.0, 3, None), (1.3, None, 0.5),
    (1.0, None, 0.9), (0.8, 5, 0.6), (1.0, 24, 1.0)])
def test_warp_masks_equal_jax_with_ties(temperature, top_k, top_p):
    x = _tied_logits()
    want = np.asarray(jwarp_fn(temperature, top_k, top_p)(jnp.asarray(x)))
    got = _warp_fn(temperature, top_k, top_p)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


def test_sampled_streams_reproducible_and_in_the_warped_support(lm):
    _, _, model = lm
    prompt = _prompts(6, (3, 5))
    kw = dict(temperature=0.9, top_k=4, top_p=0.9)
    a = generate(model, prompt, 10, seed=7, **kw)
    b = generate(model, prompt, 10, seed=7, **kw)
    c = generate(model, prompt, 10, seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    with torch.no_grad():
        lg = model(_t(a[:, :-1]))[:, 4:]
    warped = _warp_fn(0.9, 4, 0.9)(lg)
    picked = torch.gather(warped, 2, _t(a[:, 5:])[..., None])
    assert (picked > -1e29).all()
    # with eos the rows draw from the same generator: equal up to the
    # first eos, eos-padded after it
    eos = int(a[0, 7])
    e = generate(model, prompt, 10, seed=7, eos_id=eos, **kw)
    for row_a, row_e in zip(a[:, 5:], e[:, 5:]):
        hit = np.flatnonzero(row_a == eos)
        end = hit[0] + 1 if hit.size else 10
        np.testing.assert_array_equal(row_e[:end], row_a[:end])
        assert (row_e[end:] == eos).all()


# -- beam search ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(beams=1), dict(beams=3), dict(beams=4, eos_id=None,
                                       length_penalty=0.6),
    dict(beams=3, eos_id="emitted"), dict(beams=3, eos_id="emitted",
                                          length_penalty=1.0)],
    ids=["beams1", "beams3", "penalty", "eos", "eos-penalty"])
def test_beam_search_equals_jax(lm, kw):
    spec, params, model = lm
    prompt = _prompts(7, (2, 5))
    kw = dict(kw)
    if kw.get("eos_id") == "emitted":
        # a token the best beams emit early, so beams finish and freeze
        kw["eos_id"] = int(jbeam_search(spec, params, prompt, 3,
                                        beams=3)[0][0, 0, 6])
    jt, js = jbeam_search(spec, params, prompt, 9, **kw)
    tt, ts = beam_search(model, prompt, 9, **kw)
    assert tt.dtype == np.int32 and tt.shape == jt.shape
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
    if kw["beams"] == 1:
        np.testing.assert_array_equal(tt[:, 0], generate(model, prompt, 9))
    if kw.get("eos_id") is not None:
        eos = kw["eos_id"]
        hit = tt[..., 5:] == eos
        assert hit.any()
        for row in tt[..., 5:].reshape(-1, 9):
            first = np.flatnonzero(row == eos)
            if first.size:
                assert (row[first[0]:] == eos).all()   # frozen beams pad


def test_beam_search_ring_cache_and_gqa_equals_jax():
    spec, params, model = _pair(attn_window=5, kv_heads=2,
                                pos_embedding="rope")
    prompt = _prompts(8, (2, 8))
    jt, js = jbeam_search(spec, params, prompt, 8, beams=3)
    tt, ts = beam_search(model, prompt, 8, beams=3)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)


# -- GeneratorPredictor --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(beams=2), dict(eos_id="emitted", per_row_new_tokens=True),
    dict(beams=2, eos_id="emitted", per_row_new_tokens=True,
         length_penalty=0.5)],
    ids=["greedy", "beams", "eos-counts", "beams-eos-counts"])
def test_generator_predictor_equals_jax(lm, kw):
    spec, params, model = lm
    prompts = _prompts(9, (11, 4))
    kw = dict(kw)
    if kw.get("eos_id") == "emitted":
        kw["eos_id"] = int(jgenerate(spec, params, prompts, 4)[0, 6])
    cols = {"features": prompts}
    want = JGeneratorPredictor(spec, params, max_new_tokens=6, batch_size=4,
                               **kw).predict(JDataset(cols))
    got = GeneratorPredictor(model, max_new_tokens=6, batch_size=4,
                             **kw).predict(Dataset(cols))
    assert got["generated"].shape == (11, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    if kw.get("per_row_new_tokens"):
        np.testing.assert_array_equal(got["generated_new_tokens"],
                                      want["generated_new_tokens"])
        assert (got["generated_new_tokens"] < 6).any()


# -- validation ----------------------------------------------------------------


def _call(name, model, prompt, **kw):
    if name == "generate":
        return generate(model, prompt, kw.pop("n", 4), **kw)
    if name == "beam_search":
        return beam_search(model, prompt, kw.pop("n", 4), **kw)
    if name == "speculative_generate":
        return speculative_generate(model, kw.pop("draft", model), prompt,
                                    kw.pop("n", 4), **kw)
    return GeneratorPredictor(model, **kw)


@pytest.mark.parametrize("name,kw,err,match", [
    ("generate", dict(model="spec"), TypeError, "TransformerLM"),
    ("generate", dict(prompt=np.zeros(4, np.int32)), ValueError,
     r"\[batch, length\]"),
    ("generate", dict(n=MAXLEN), ValueError, "maxlen"),
    ("generate", dict(n=0), ValueError, "max_new_tokens must be >= 1"),
    ("generate", dict(temperature=1.0, top_k=0), ValueError, "top_k"),
    ("generate", dict(temperature=1.0, top_k=VOCAB + 1), ValueError,
     "top_k"),
    ("generate", dict(temperature=1.0, top_p=0.0), ValueError, "top_p"),
    ("generate", dict(temperature=1.0, top_p=1.5), ValueError, "top_p"),
    ("generate", dict(eos_id=VOCAB), ValueError, "eos_id"),
    ("beam_search", dict(beams=0), ValueError, "beams"),
    ("beam_search", dict(beams=VOCAB + 1), ValueError, "beams"),
    ("beam_search", dict(eos_id=-1), ValueError, "eos_id"),
    ("beam_search", dict(n=MAXLEN), ValueError, "maxlen"),
    ("speculative_generate", dict(draft="spec"), TypeError, "draft"),
    ("speculative_generate", dict(spec_tokens=0), ValueError,
     "spec_tokens"),
    ("speculative_generate", dict(n=MAXLEN - 5, spec_tokens=4), ValueError,
     "spec_tokens"),
    ("speculative_generate", dict(temperature=-1.0), ValueError,
     "temperature"),
    ("speculative_generate", dict(temperature=1.0, top_k=0), ValueError,
     "top_k"),
    ("speculative_generate", dict(temperature=1.0, top_p=1.5), ValueError,
     "top_p"),
    ("GeneratorPredictor", dict(beams=0), ValueError, "beams"),
    ("GeneratorPredictor", dict(beams=2, temperature=0.5), ValueError,
     "deterministic"),
    ("GeneratorPredictor", dict(length_penalty=0.5), ValueError,
     "length_penalty"),
    ("GeneratorPredictor", dict(model="spec"), TypeError, "TransformerLM"),
])
def test_decoding_validation_errors_equal_jax(lm, name, kw, err, match):
    """Every refusal the JAX package's decoding functions raise, raised by
    the port's with the same type (the JAX spec stands in for a
    non-module argument)."""
    spec, params, model = lm
    kw = dict(kw)
    prompt = kw.pop("prompt", np.zeros((1, 5), np.int32))
    if kw.get("model") == "spec":
        kw.pop("model")
        model = spec
    if kw.get("draft") == "spec":
        kw["draft"] = spec
    with pytest.raises(err, match=match):
        _call(name, model, prompt, **kw)


def test_speculative_refuses_windows_and_vocab_mismatch(lm):
    _, _, model = lm
    _, _, windowed = _pair(attn_window=4)
    _, _, other = _pair(vocab=32, maxlen=MAXLEN, dim=32, heads=4, depth=1)
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="sliding-window"):
        speculative_generate(model, windowed, prompt, 4)
    with pytest.raises(ValueError, match="sliding-window"):
        speculative_generate(windowed, model, prompt, 4)
    with pytest.raises(ValueError, match="vocab"):
        speculative_generate(model, other, prompt, 4)
