"""``ops.quant.quantize_serving`` and ``ModelPredictor(quantize=True)`` on
the port held against the JAX package's.

The same float weights (``convert.tensors_from_jax``) go through both
packages' ``quantize_serving``: the set of layers quantized must be equal
(the port's module names mapped to flax paths), the int8 weights and
scales bit-equal (both quantize symmetric absmax per output channel), and
the int8 logits on the same numpy inputs equal within 1e-4 of the logits'
scale (f32 summation order; the JAX side serves through ``q_matmul``, the
port through its plain version on the CPU). The int8 model stays within
5% of the float model's logit scale, the error int8 weights carry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.data as jdata
from distkeras_tpu import predictors as jpred
from distkeras_tpu.models import lenet as jlenet
from distkeras_tpu.models import lstm_classifier as jlstm
from distkeras_tpu.models import mlp as jmlp
from distkeras_tpu.models import transformer_classifier as jtransformer
from distkeras_tpu.ops.quant import quantize_serving as jquantize_serving
from distkeras_tpu_torch import data as tdata
from distkeras_tpu_torch import predictors as tpred
from distkeras_tpu_torch.convert import (
    _flax_parts,
    _nchw_cols_to_nhwc,
    tensors_from_jax,
)
from distkeras_tpu_torch.models import (
    lenet,
    lstm_classifier,
    mlp,
    transformer_classifier,
)
from distkeras_tpu_torch.ops.quant import QDense, quantize_serving

INT8_REL = 1e-4     # port int8 against JAX int8, of the logits' scale
FLOAT_REL = 0.05    # int8 against float, of the logits' scale

SEQ = dict(vocab=50, maxlen=12)


def _zoo(kind):
    """(JAX spec, port spec, inputs as a numpy tuple)."""
    rng = np.random.default_rng(0)
    if kind == "mlp":
        shape = (12,)
        return (jmlp(input_shape=shape, hidden=(32, 16), num_classes=5,
                     dtype=jnp.float32),
                mlp(input_shape=shape, hidden=(32, 16), num_classes=5,
                    dtype=torch.float32),
                (rng.uniform(0, 1, (6, 12)).astype(np.float32),))
    if kind == "lenet":
        return (jlenet(dtype=jnp.float32), lenet(dtype=torch.float32),
                (rng.uniform(0, 1, (3, 28, 28, 1)).astype(np.float32),))
    tokens = rng.integers(1, SEQ["vocab"], (4, SEQ["maxlen"]))
    mask = (np.arange(SEQ["maxlen"])[None] < np.array([[12], [7], [3], [9]])
            ).astype(np.float32)
    if kind == "transformer":
        kw = dict(dim=32, heads=4, depth=2, num_classes=3, **SEQ)
        return (jtransformer(dtype=jnp.float32, **kw),
                transformer_classifier(dtype=torch.float32, **kw),
                (tokens.astype(np.int32), mask))
    kw = dict(embed_dim=16, hidden_dim=16, num_classes=2, **SEQ)
    return (jlstm(dtype=jnp.float32, **kw),
            lstm_classifier(dtype=torch.float32, scan_impl="reference",
                            **kw),
            (tokens.astype(np.int32), mask))


def _jax_int8_paths(tree, path=()):
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            return {path}
        return set().union(*(_jax_int8_paths(v, path + (k,))
                             for k, v in tree.items()))
    return set()


def _port_inputs(xs):
    return tuple(torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32
                                  else x) for x in xs)


@pytest.mark.parametrize("kind", ["mlp", "lenet", "transformer", "lstm"])
def test_quantized_paths_weights_and_logits_equal_jax(kind):
    jspec, tspec, xs = _zoo(kind)
    jp, jnt = jspec.init_np(0)
    tp = tensors_from_jax(jp, tspec.module)
    tp = {k: v for k, v in tp.items()
          if k in dict(tspec.module.named_parameters())}
    jq_spec, jq = jquantize_serving(jspec, jp, state=jnt)
    q_spec, q = quantize_serving(tspec, tp)
    # the same layers quantized
    port_paths = {tuple(_flax_parts(k.rpartition(".")[0]))
                  for k in q if k.endswith(".kernel_q")}
    assert port_paths == _jax_int8_paths(jq) and port_paths
    # bit-equal int8 weights and scales (the port keeps [out, in], and a
    # Dense over a flattened feature map reads NCHW where flax reads NHWC)
    for path in port_paths:
        node = jq
        for part in path:
            node = node[part]
        name = ".".join(path).replace("blocks_", "blocks.")
        chw = getattr(tspec.module.get_submodule(name), "nhwc_from", None)
        kq = q[f"{name}.kernel_q"].numpy()
        np.testing.assert_array_equal(
            _nchw_cols_to_nhwc(kq, chw) if chw is not None else kq.T,
            np.asarray(node["kernel_q"]))
        np.testing.assert_array_equal(q[f"{name}.scale"].numpy(),
                                      np.asarray(node["scale"]))
        assert isinstance(q_spec.module.get_submodule(name), QDense)
    # everything else passes through unchanged
    assert {k for k in q if not k.endswith((".kernel_q", ".scale"))} == \
        {k for k in tp if not k.endswith(".weight")
         or k.rpartition(".")[0] not in
         {".".join(p).replace("blocks_", "blocks.") for p in port_paths}}
    jx = tuple(jnp.asarray(x) for x in xs)
    jx = jx[0] if len(jx) == 1 else jx
    want, _ = jq_spec.apply(jq, jnt, jx, False)
    fwant, _ = jspec.apply(jp, jnt, jx, False)
    tx = _port_inputs(xs)
    with torch.no_grad():
        got, _ = q_spec.apply(q, {}, tx[0] if len(tx) == 1 else tx, False)
    want, fwant = np.asarray(want), np.asarray(fwant)
    scale = np.abs(fwant).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=INT8_REL * scale)
    np.testing.assert_allclose(got.numpy(), fwant, rtol=0,
                               atol=FLOAT_REL * scale)
    assert q_spec.name == tspec.name + "_int8"
    assert q_spec.fused_losses is None


def test_quantized_spec_refuses_training_and_unrecorded_specs():
    jspec, tspec, xs = _zoo("mlp")
    params, _ = tspec.init(0)
    q_spec, q = quantize_serving(tspec, params)
    with pytest.raises(ValueError, match="serving path"):
        q_spec.apply(q, {}, torch.from_numpy(xs[0]), True)
    with pytest.raises(ValueError, match="example input"):
        quantize_serving(dataclasses.replace(tspec, example=None), params)
    with pytest.raises(ValueError, match="from_module"):
        quantize_serving(dataclasses.replace(tspec, module=None), params)
    # the float spec and params are untouched
    assert "Dense_0.weight" in params and tspec.module.Dense_0 is not \
        q_spec.module.Dense_0


@pytest.mark.parametrize("kind", ["mlp", "transformer"])
def test_model_predictor_quantize_equals_jax(kind):
    jspec, tspec, xs = _zoo(kind)
    jp, jnt = jspec.init_np(0)
    tp = tensors_from_jax(jp, tspec.module)
    tp = {k: v for k, v in tp.items()
          if k in dict(tspec.module.named_parameters())}
    cols = {"features": xs[0]}
    fcols = ["features"]
    if len(xs) > 1:
        cols["mask"] = xs[1]
        fcols.append("mask")
    want = jpred.ModelPredictor(jspec, jp, jnt, features_col=fcols,
                                batch_size=4, quantize=True).predict(
        jdata.Dataset(cols))["prediction"]
    pred = tpred.ModelPredictor(tspec, tp, {}, features_col=fcols,
                                batch_size=4, quantize=True, device="cpu")
    got = pred.predict(tdata.Dataset(cols))["prediction"]
    assert pred.spec.name.endswith("_int8")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=INT8_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
