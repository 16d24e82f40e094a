"""The yardstick's arithmetic against counts made by hand."""

from __future__ import annotations

import pytest

from portbench.flops import flash, lm, peaks


def test_lm_flops_per_token_by_hand():
    d, depth, V = 1024, 8, 16384
    # 3 × [8 × (24·1024² + 2·2048·1024) + 2·1024·16384]
    assert lm.train_flops_per_token(d, depth, 2048, V) == 805_306_368
    assert lm.train_flops_per_token(d, depth, 16384, V) == 1_509_949_440


def test_flash_counts_by_hand():
    B, L, H, D = 16, 2048, 8, 128
    pairs = 16 * 2048 * 2049 // 2
    assert flash.causal_pairs(B, L) == pairs
    ops, nbytes = flash.k2(B, L, H, H, D)
    assert ops == 4 * pairs * H * D
    # q, o, k, v in bf16, the f32 log-sum-exp
    assert nbytes == 4 * B * L * H * D * 2 + B * H * L * 4
    assert flash.k3(B, L, H, H, D)[0] == 1.5 * ops
    assert flash.k4(B, L, H, H, D)[0] == 2 * ops
    # the kernel table's bounds at config 9's shape (µs)
    bounds = [peaks.bound_s(*k(B, L, H, H, D), "bf16") * 1e6
              for k in (flash.k2, flash.k3, flash.k4)]
    assert bounds == pytest.approx([139.0, 208.6, 278.1], abs=0.06)


def test_peaks_table():
    assert peaks.flops("bf16") == 989e12
    assert peaks.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert peaks.bound_s(989e12, 0.0, "bf16") == 1.0
