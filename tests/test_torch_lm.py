"""The port's LM (distkeras_tpu_torch/models/lm.py) held against the JAX
package through the weight bridge (distkeras_tpu_torch/convert.py).

Weights come from the JAX spec's ``init_np(0)`` and are loaded into the
port; both sides run in f32 on the same tokens, pools and tables. 1e-4
absolute on logits (and on the K/V the pools receive) covers f32
summation-order noise through a few layers; anything structural — a wrong
transpose, a RoPE pairing, a LayerNorm epsilon, GELU flavour, head factoring
or mask — is orders of magnitude larger.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import quantize_lm as jquantize_lm
from distkeras_tpu.models import transformer_lm as jtransformer_lm
from distkeras_tpu.models.lm import TransformerLM as JLM
from distkeras_tpu.models.lm import apply_rope as japply_rope
from distkeras_tpu.models.lm import rope_angles as jrope_angles
from distkeras_tpu.models.transformer import sincos_positions as jsincos
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import lm as tlm
from distkeras_tpu_torch.models.lm import TransformerLM
from distkeras_tpu_torch.models.transformer import sincos_positions

ATOL = 1e-4


def _pair(quant=False, **cfg):
    """(JAX module, JAX params, port model with the same weights)."""
    spec = jtransformer_lm(dtype=jnp.float32, **cfg)
    params, _ = spec.init_np(0)
    module = spec.module
    if quant:
        qspec, params = jquantize_lm(spec, params)
        module = qspec.module
    model = TransformerLM(dtype=torch.float32, quant=quant, device="cpu",
                          **cfg)
    params_from_jax(params, model)
    return module, params, model.eval()


def _pools(rng, S, hkv, dh, depth):
    return [rng.normal(size=(S, hkv, dh)).astype(np.float32)
            for _ in range(depth)]


def _check_model(module, params, model, rng, vocab, block_size=4):
    apply = lambda *a, **k: module.apply({"params": params}, *a, **k)  # noqa
    B, L = 2, 12
    tokens = rng.integers(0, vocab, (B, L)).astype(np.int32)
    tt = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        # full forward
        np.testing.assert_allclose(model(tt).numpy(),
                                   np.asarray(apply(jnp.asarray(tokens))),
                                   rtol=0, atol=ATOL)
        # prefill_raw: logits and every block's K/V
        jl, jkv = apply(jnp.asarray(tokens), method=JLM.prefill_raw)
        tl, tkv = model.prefill_raw(tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        for (jk, jv), (tk, tv) in zip(jkv, tkv):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                       atol=ATOL)
        # one paged decode step: rows at different positions, scrambled
        # block tables, random pool contents (unwritten slots must mask)
        bs, nb = block_size, 4
        nblocks = 1 + B * nb
        hkv = model.blocks[0].hkv
        dh = model.dim // model.heads
        kps = _pools(rng, nblocks * bs, hkv, dh, model.depth)
        vps = _pools(rng, nblocks * bs, hkv, dh, model.depth)
        tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
        positions = np.array([5, 13], np.int32)
        write = np.array([tables[b, p // bs] * bs + p % bs
                          for b, p in enumerate(positions)], np.int32)
        tok = rng.integers(0, vocab, (B,)).astype(np.int32)
        jlog, jk, jv = apply(
            jnp.asarray(tok), tuple(map(jnp.asarray, kps)),
            tuple(map(jnp.asarray, vps)), jnp.asarray(tables),
            jnp.asarray(write), jnp.asarray(positions), bs,
            method=JLM.paged_decode_step)
        tk = [torch.from_numpy(p.copy()) for p in kps]
        tv = [torch.from_numpy(p.copy()) for p in vps]
        i64 = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa
        tlog, tk2, tv2 = model.paged_decode_step(
            i64(tok), tk, tv, i64(tables), i64(write), i64(positions), bs)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL)
        for a, b in zip(tk2 + tv2, list(jk) + list(jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)
        assert all(a is b for a, b in zip(tk2, tk))   # updated in place


@pytest.mark.parametrize("pos_embedding", ["sincos", "rope"])
@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("tie_embeddings", [False, True])
def test_lm_parity_vs_jax_f32(pos_embedding, kv_heads, tie_embeddings):
    cfg = dict(vocab=64, maxlen=32, dim=32, heads=4, depth=2,
               pos_embedding=pos_embedding, kv_heads=kv_heads,
               tie_embeddings=tie_embeddings)
    module, params, model = _pair(**cfg)
    _check_model(module, params, model, np.random.default_rng(0), 64)


def test_int8_lm_parity_vs_jax_pallas_interpret():
    """JAX quantize_lm → bridge → port; the JAX side's QDense layers run
    the Pallas q_matmul kernel in interpret mode (K, N tile at dim 128)."""
    cfg = dict(vocab=128, maxlen=32, dim=128, heads=4, depth=1,
               pos_embedding="rope", kv_heads=1)
    module, params, model = _pair(quant=True, **cfg)
    assert isinstance(model.blocks[0].qkv, tlm.QDense)
    assert model.blocks[0].qkv.kernel_q.shape == (4 * 32 + 2 * 32, 128)
    _check_model(module, params, model, np.random.default_rng(1), 128)


def test_position_tables_and_rope_match_jax():
    np.testing.assert_array_equal(sincos_positions(16, 8), jsincos(16, 8))
    np.testing.assert_array_equal(tlm.rope_angles(16, 8),
                                  jrope_angles(16, 8))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 3, 8)).astype(np.float32)
    ang = jrope_angles(16, 8)
    np.testing.assert_allclose(
        tlm.apply_rope(torch.from_numpy(x), torch.from_numpy(ang)).numpy(),
        np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(ang))),
        rtol=0, atol=1e-6)


def test_quantize_lm_quantizes_the_ports_own_weights():
    model = tlm.transformer_lm(vocab=64, maxlen=16, dim=32, heads=4,
                               depth=1, dtype=torch.float32, device="cpu")
    qmodel = tlm.quantize_lm(model)
    qd, d = qmodel.blocks[0].mlp_up, model.blocks[0].mlp_up
    ref = tlm.quantize(d.weight.detach(), axis=1)
    assert torch.equal(qd.kernel_q, ref.q) and torch.equal(qd.scale,
                                                           ref.scale)
    tokens = torch.randint(0, 64, (2, 8), generator=torch.Generator()
                           .manual_seed(0))
    with torch.no_grad():
        a, b = model(tokens), qmodel(tokens)
    assert torch.isfinite(b).all()
    assert (a - b).abs().max() < 0.05 * a.abs().max()   # int8 rounding only
    with pytest.raises(ValueError, match="already quantized"):
        tlm.quantize_lm(qmodel)


def test_init_follows_flax_defaults():
    model = tlm.transformer_lm(vocab=512, maxlen=16, dim=256, heads=4,
                               depth=1, dtype=torch.float32, device="cpu",
                               seed=3)
    w = model.blocks[0].mlp_up.weight.detach()
    std = 256 ** -0.5 / .87962566103423978
    assert w.abs().max() <= 2 * std + 1e-6
    assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    e = model.embed.weight.detach()
    assert abs(e.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert torch.all(model.blocks[0].qkv.bias == 0)
    assert torch.all(model.ln_head.weight == 1)
    again = tlm.transformer_lm(vocab=512, maxlen=16, dim=256, heads=4,
                               depth=1, dtype=torch.float32, device="cpu",
                               seed=3)
    assert torch.equal(again.blocks[0].mlp_up.weight, w)


def test_bridge_rejects_mismatched_trees():
    spec = jtransformer_lm(vocab=64, maxlen=16, dim=32, heads=4, depth=1,
                           dtype=jnp.float32)
    params, _ = spec.init_np(0)
    wrong = TransformerLM(vocab=64, maxlen=16, dim=32, heads=4, depth=2,
                          dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="does not provide"):
        params_from_jax(params, wrong)
    wider = TransformerLM(vocab=64, maxlen=16, dim=32, heads=4, depth=1,
                          kv_heads=2, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, wider)
