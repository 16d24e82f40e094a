"""The port's int8 weight-only quantization (distkeras_tpu_torch/ops/quant.py)
held against the JAX package on the same numpy inputs.

On the CPU ``q_matmul`` runs its plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``. Tolerances:
f32 products of int8 and f32 values accumulate in f32 on both sides, only
the summation order differs (1e-5 absolute at these magnitudes); bf16
outputs round the same f32 accumulator, so they differ by at most an ulp
of the result (2e-2 relative) plus summation-order noise near zero.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.ops.quant as jq
from distkeras_tpu_torch.ops import quant as tq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(rng, k, n):
    w = rng.normal(0.0, 0.05, (k, n)).astype(np.float32)
    w[:, 3 % n] = 0.0          # an all-zero channel takes scale 1
    w[5 % k, 7 % n] = 0.5      # an outlier sets its channel's scale
    return w


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_bit_exact_vs_jax(axis):
    w = _weights(np.random.default_rng(0), 96, 80)
    ref = jq.quantize(jnp.asarray(w), axis=axis)
    got = tq.quantize(torch.from_numpy(w), axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        tq.dequantize(got, axis=axis).numpy(),
        np.asarray(jq.dequantize(ref, axis=axis)))


def test_quantize_rejects_bad_input():
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize(torch.zeros(3))
    with pytest.raises(ValueError, match="axis"):
        tq.quantize(torch.zeros(3, 3), axis=2)


@pytest.mark.parametrize("with_paths", [False, True])
def test_quantize_dense_tree_matches_jax(with_paths):
    rng = np.random.default_rng(1)
    tree = {
        "dense": {"kernel": _weights(rng, 16, 8),
                  "bias": rng.normal(size=8).astype(np.float32)},
        "nobias": {"kernel": _weights(rng, 8, 4)},
        "ln": {"scale": np.ones(8, np.float32),
               "bias": np.zeros(8, np.float32)},
        "deep": {"inner": {"kernel": _weights(rng, 4, 4),
                           "bias": np.zeros(4, np.float32)}},
    }
    paths = {("dense",), ("nobias",)} if with_paths else None
    ref = jq.quantize_dense_tree(tree, paths=paths)
    got = tq.quantize_dense_tree(tree, paths=paths)

    def walk(a, b):
        assert isinstance(a, dict) == isinstance(b, dict)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))

    walk(ref, got)
    assert ("kernel_q" in got["nobias"]) == with_paths
    assert "kernel_q" in got["dense"] and "kernel_q" not in got["ln"]


@pytest.mark.parametrize("m", [1, 5, 40, 80, 336])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_matmul_plain_vs_jax_pallas(m, dtype):
    rng = np.random.default_rng(2)
    k = n = 256
    w = _weights(rng, k, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    qt = jq.quantize(jnp.asarray(w), axis=0)
    ref = jq.q_matmul(jnp.asarray(x).astype(jdt), qt, impl="pallas",
                      interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tqt = tq.QTensor(torch.from_numpy(np.array(qt.q)).t().contiguous(),
                     torch.from_numpy(np.array(qt.scale)))
    got = tq.q_matmul(torch.from_numpy(x).to(tdt), tqt)
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-2,
                                   atol=1e-4 * np.abs(ref).max())


def test_q_matmul_shapes_and_leading_dims():
    rng = np.random.default_rng(3)
    w = _weights(rng, 24, 40)          # ragged K, N: any shape runs
    x = rng.normal(size=(2, 3, 24)).astype(np.float32)
    qt = tq.quantize(torch.from_numpy(w).t(), axis=1)   # q [N, K]
    out = tq.q_matmul(torch.from_numpy(x), qt)
    assert out.shape == (2, 3, 40)
    exact = x @ (tq.dequantize(qt, axis=1).numpy().T)
    np.testing.assert_allclose(out.numpy(), exact, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="trailing dim"):
        tq.q_matmul(torch.zeros(2, 23), qt)
    launches = tq.q_matmul.launches
    tq.q_matmul(torch.from_numpy(x), qt)
    assert tq.q_matmul.launches == launches   # the CPU runs no kernel


def _dense_shapes():
    """(K, N) of every Dense layer of the served config, as chip_smoke.py
    drives them."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_dense", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DENSE


PLAN_SHAPES = [(m, k, n) for k, n in _dense_shapes()
               for m in (8, 13, 80, 336, 1024)]


def _most_decode_blocks(n, k):
    """The most blocks any plan of the split decode kernel can give."""
    return -(-n // tq.DECODE_CHANNELS) * min(tq.MAX_DECODE_SPLITS,
                                             -(-k // tq.DECODE_CHUNK))


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES,
                         ids=[f"M{m}K{k}N{n}" for m, k, n in PLAN_SHAPES])
def test_plan_covers_the_product_once_and_fills_the_card(m, k, n):
    """``plan_q_matmul`` at every Dense shape of the served config, decode
    (8, 13) and prefill (80, 336, 1024) rows: the blocks cover every
    output channel and token once (the last tile only partly), the K split
    hands every chunk to exactly one block of a cluster (at most 8 blocks
    for decode, 3 for prefill, and a prefill split only within one wave),
    and the grid fills the card: decode with at least two blocks a SM
    where the shape allows, prefill with blocks on at least 70% of the
    SMs."""
    plan = tq.plan_q_matmul(m, n, k)
    gx, gy, gz = plan.grid
    assert plan.kernel == ("decode" if m <= 16 else "prefill")
    assert plan.chunk == (tq.DECODE_CHUNK if m <= 16 else tq.CHUNK)
    assert gx * plan.channels >= n > (gx - 1) * plan.channels
    assert gy * plan.tokens >= m > (gy - 1) * plan.tokens
    assert gz == plan.splits
    chunks = -(-k // plan.chunk)
    covered = []
    for r in range(plan.splits):
        lo, hi = tq.chunk_range(r, plan.splits, chunks)
        assert hi > lo
        covered += range(lo, hi)
    assert covered == list(range(chunks))
    if m <= tq.DECODE_M:
        assert plan.splits <= tq.MAX_DECODE_SPLITS
        assert plan.blocks >= min(2 * tq.SMS, _most_decode_blocks(n, k))
        return
    assert plan.tokens in tq.TOKEN_TILES and plan.channels == 64 * plan.wg
    assert plan.splits <= tq.MAX_SPLITS
    assert plan.splits == 1 or plan.blocks <= tq.SMS
    assert min(plan.blocks, tq.SMS) >= 0.7 * tq.SMS


@pytest.mark.parametrize("m,k,n,aligned,kernel", [
    (8, 200, 300, True, "decode_direct"),     # K % 16: no 16-byte rows
    (40, 77, 130, True, "prefill_direct"),
    (8, 2048, 2304, False, "decode_direct"),  # x or q not 16-byte aligned
    (40, 2048, 2304, False, "prefill_direct"),
    (17, 64, 8, True, "prefill"),             # the smallest prefill
    (16, 16, 8, True, "decode"),
])
def test_plan_takes_the_element_masked_kernels_where_rows_do_not_fit(
        m, k, n, aligned, kernel):
    plan = tq.plan_q_matmul(m, n, k, aligned=aligned)
    assert plan.kernel == kernel
    assert plan.splits <= -(-k // plan.chunk)
    assert tq.plan_q_matmul(m, n, k, torch.float32).kernel == "f32"
