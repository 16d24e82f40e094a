"""The flash-attention kernels' operations and bytes per call, as the
kernel table counts them (``chip_smoke.py``'s ``check_flash`` and
``check_flash_bwd``): causal pairs only, each input byte read once and
each output byte written once.

K2 (forward) reads q, k, v and writes o and the f32 log-sum-exp;
K3 (dq) reads q, dout, k, v, lse and delta and writes dq, recomputing the
scores; K4 (dk, dv) reads q, dout, k, v, lse and delta and writes dk and
dv. ``B`` counts every row the call covers (the engine's W workers fold
into it)."""


def causal_pairs(B: int, L: int) -> int:
    return B * L * (L + 1) // 2


def _bytes(B, L, H, Hkv, D, esz):
    q, kv = B * L * H * D * esz, B * L * Hkv * D * esz
    return q, kv, 2 * B * H * L * 4


def k2(B, L, H, Hkv, D, esz=2):
    """``(operations, bytes)`` of one forward call."""
    q, kv, _ = _bytes(B, L, H, Hkv, D, esz)
    return 4.0 * causal_pairs(B, L) * H * D, 2 * q + 2 * kv + B * H * L * 4


def k3(B, L, H, Hkv, D, esz=2):
    q, kv, rows = _bytes(B, L, H, Hkv, D, esz)
    return 6.0 * causal_pairs(B, L) * H * D, 3 * q + 2 * kv + rows


def k4(B, L, H, Hkv, D, esz=2):
    q, kv, rows = _bytes(B, L, H, Hkv, D, esz)
    return 8.0 * causal_pairs(B, L) * H * D, 2 * q + 4 * kv + rows
