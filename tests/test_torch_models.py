"""The port's training zoo, weight bridge, losses and metrics held against
the JAX package on the same numpy inputs.

Models run in f32 on both sides from one flax init carried over by
``convert.tensors_from_jax``; ``params_to_jax`` must give back the flax
tree with the same leaf paths and values (exact: layout moves only).
Tolerances: the same f32 arithmetic in another summation order, 1e-5
relative and absolute for logits and losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import models as jm
from distkeras_tpu.ops import losses as jl
from distkeras_tpu.ops import metrics as jmet
from distkeras_tpu_torch import models as tm
from distkeras_tpu_torch.convert import (
    params_from_jax,
    params_to_jax,
    tensors_from_jax,
)
from distkeras_tpu_torch.ops import losses as tl
from distkeras_tpu_torch.ops import metrics as tmet

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(name):
    if name == "lstm":
        kw = dict(vocab=300, embed_dim=16, hidden_dim=32)
        return (jm.lstm_classifier(maxlen=12, dtype=jnp.float32,
                                   scan_impl="xla", **kw),
                tm.lstm_classifier(dtype=torch.float32, **kw))
    if name == "mlp":
        return (jm.mlp(hidden=(32, 16), dtype=jnp.float32),
                tm.mlp(hidden=(32, 16), dtype=torch.float32))
    if name == "lenet":
        return jm.lenet(dtype=jnp.float32), tm.lenet(dtype=torch.float32)
    return (jm.vgg_small(dtype=jnp.float32),
            tm.vgg_small(dtype=torch.float32))


def _inputs(name, rng):
    if name == "lstm":
        toks = rng.integers(0, 300, (4, 12)).astype(np.int32)
        mask = np.ones((4, 12), np.float32)
        mask[:, 9:] = 0.0
        mask[1, 4:] = 0.0
        return (toks, mask)
    if name == "vgg":
        return rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return rng.normal(size=(4, 28, 28, 1)).astype(np.float32)


def _torch_in(x):
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(a) for a in x)
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", ["lstm", "mlp", "lenet", "vgg"])
def test_model_matches_flax_through_the_bridge(name):
    """vgg and lenet cover the conv HWIO → OIHW move and the NHWC flatten
    permutation of the first Dense; lstm the bare ``wh`` leaf."""
    jspec, tspec = _pair(name)
    p, nt = jspec.init_np(0)
    x = _inputs(name, np.random.default_rng(1))
    ref, _ = jspec.apply(p, nt, x, False)
    got, _ = tspec.apply(tensors_from_jax(p, tspec.module), {}, _torch_in(x),
                         False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["lstm", "mlp", "lenet", "vgg"])
def test_params_to_jax_round_trips(name):
    jspec, tspec = _pair(name)
    p, _ = jspec.init_np(0)
    back = params_to_jax(tensors_from_jax(p, tspec.module), tspec.module)
    ref = jax.tree_util.tree_leaves_with_path(p)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, np.asarray(a))


def test_bridge_keeps_port_layouts_and_raises_on_mismatch():
    jspec, tspec = _pair("lenet")
    p, _ = jspec.init_np(0)
    t = tensors_from_jax(p, tspec.module)
    assert tuple(t["Conv_0.weight"].shape) == (32, 1, 5, 5)     # OIHW
    assert tuple(t["Dense_0.weight"].shape) == (256, 64 * 7 * 7)
    # a feature map of ones in channel 0 only reads the kernel rows the
    # NHWC flatten gives channel 0: rows c::C
    fmap = torch.zeros(1, 64, 7, 7)
    fmap[0, 0] = 1.0
    got = (t["Dense_0.weight"] @ fmap.reshape(-1)).numpy()
    ref = p["Dense_0"]["kernel"][0::64].sum(axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    bad = {**p, "Dense_1": {"kernel": np.zeros((3, 3), np.float32),
                            "bias": p["Dense_1"]["bias"]}}
    with pytest.raises(ValueError, match="shape"):
        tensors_from_jax(bad, tspec.module)
    with pytest.raises(KeyError, match="does not provide"):
        tensors_from_jax({k: v for k, v in p.items() if k != "Dense_1"},
                         tspec.module)


def test_params_from_jax_copies_a_bare_leaf_in_place():
    jspec, tspec = _pair("lstm")
    p, _ = jspec.init_np(0)
    module = tm.LSTMClassifier(vocab=300, embed_dim=16, hidden_dim=32,
                               dtype=torch.float32)
    params_from_jax(p, module)
    np.testing.assert_array_equal(module.wh.detach().numpy(), p["wh"])


def test_spec_init_is_seeded_and_float32():
    spec = tm.lstm_classifier(vocab=50, embed_dim=8, hidden_dim=16)
    a, state = spec.init(3)
    b, _ = spec.init(3)
    c, _ = spec.init(4)
    assert state == {}
    assert set(a) == {"Embed_0.weight", "wx.weight", "wx.bias", "wh",
                      "Dense_0.weight", "Dense_0.bias"}
    for k in a:
        assert a[k].dtype == torch.float32
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["wh"], c["wh"])
    wh = a["wh"]                                  # orthogonal rows
    torch.testing.assert_close(wh @ wh.T, torch.eye(16), rtol=0, atol=1e-5)
    np_params, _ = spec.init_np(3)
    np.testing.assert_array_equal(np_params["wh"], wh.numpy())


def test_lstm_bf16_computes_in_bf16_with_f32_wh():
    spec = tm.lstm_classifier(vocab=50, embed_dim=8, hidden_dim=16)
    params, _ = spec.init(0)
    toks = torch.randint(0, 50, (2, 5))
    out, _ = spec.apply(params, {}, (toks, torch.ones(2, 5)), False)
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    assert torch.isfinite(out).all()


LOSS_NAMES = ["mse", "mae", "categorical_crossentropy",
              "softmax_cross_entropy", "sparse_softmax_cross_entropy",
              "sparse_categorical_crossentropy", "binary_crossentropy",
              "sigmoid_binary_crossentropy"]


def _loss_inputs(name, rng):
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, 5, size=(6,)).astype(np.int32)
    onehot = np.eye(5, dtype=np.float32)[labels]
    if name in ("mse", "mae"):
        return onehot, logits
    if name == "categorical_crossentropy":
        return onehot, probs
    if name == "softmax_cross_entropy":
        return onehot, logits
    if name == "sparse_softmax_cross_entropy":
        return labels, logits
    if name == "sparse_categorical_crossentropy":
        return labels, probs
    y = rng.integers(0, 2, size=(6, 1)).astype(np.float32)
    if name == "binary_crossentropy":
        return y, 1 / (1 + np.exp(-logits[:, :1]))
    return y, logits[:, :1]


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_match_jax(name):
    y, out = _loss_inputs(name, np.random.default_rng(2))
    ref = float(jl.get_loss(name)(jnp.asarray(y), jnp.asarray(out)))
    got = tl.get_loss(name)(torch.from_numpy(y), torch.from_numpy(out))
    np.testing.assert_allclose(got.item(), ref, **TOL)


def test_masked_sparse_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    ref = float(jl.masked_sparse_softmax_cross_entropy(
        jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(mask)))
    got = tl.masked_sparse_softmax_cross_entropy(
        torch.from_numpy(labels), torch.from_numpy(logits),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), ref, **TOL)


def test_get_loss_names_and_errors():
    assert sorted(tl._LOSSES) == sorted(jl._LOSSES)
    fn = lambda y, p: p
    assert tl.get_loss(fn) is fn
    with pytest.raises(ValueError, match="unknown loss"):
        tl.get_loss("hinge")


@pytest.mark.parametrize("onehot", [False, True])
def test_metrics_match_jax(onehot):
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(20, 6)).astype(np.float32)
    labels = rng.integers(0, 6, size=(20,)).astype(np.int32)
    y = np.eye(6, dtype=np.float32)[labels] if onehot else labels
    for jf, tf in ((jmet.accuracy, tmet.accuracy),
                   (jmet.top_k_accuracy, tmet.top_k_accuracy)):
        ref = float(jf(jnp.asarray(y), jnp.asarray(scores)))
        got = tf(torch.from_numpy(y), torch.from_numpy(scores)).item()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    binary = rng.random((20, 1)).astype(np.float32)
    yb = rng.integers(0, 2, (20,)).astype(np.int32)
    np.testing.assert_allclose(
        tmet.accuracy(torch.from_numpy(yb), torch.from_numpy(binary)).item(),
        float(jmet.accuracy(jnp.asarray(yb), jnp.asarray(binary))), atol=1e-7)
