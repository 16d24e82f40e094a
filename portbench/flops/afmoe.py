"""AFMoE's (Trinity's) training operations and its kernels' work, from
shapes (the configuration's ``kwargs``):

- :func:`band_pairs`: the (query, key) pairs a causal call banded to
  ``window`` computes, ``i − j < window``;
- :func:`flash_calls`: K2, K3 and K4's ``(operations, bytes)`` at GQA for
  a number of pairs, as ``flops/flash.py`` counts them (each input byte
  read once, each output byte written once);
- :func:`grouped_products`: the expert layer's six grouped products a
  layer call (``ops/moe_gemm.py``: the forward's gate|up and down, the
  backward's input and weight gradients of each) over ``rows`` sorted
  rows in ``groups`` experts, bf16;
- :func:`train_flops_per_token`: three times the forward's matrix
  products a token outside the routed experts (the attention's q|k|v|gate
  and output projections, its QKᵀ and AV over the keys a query sees on
  average, the dense and shared SwiGLUs, the router, the head), and
  :func:`expert_flops_per_pair` for each routed (token, expert) pair
  computed. The flash backward's recomputation is not counted.
"""

from portbench.flops import flash


def band_pairs(B: int, L: int, window: int | None) -> int:
    """Pairs with ``0 <= i − j < window`` (causal when None)."""
    if window is None or window >= L:
        return flash.causal_pairs(B, L)
    return B * (window * (window + 1) // 2 + (L - window) * window)


def flash_calls(B: int, L: int, H: int, Hkv: int, D: int, pairs: int,
                esz: int = 2) -> list:
    """``[(operations, bytes)]`` of K2, K3 and K4 for one call."""
    q, kv, rows = flash._bytes(B, L, H, Hkv, D, esz)
    return [(4.0 * pairs * H * D, 2 * q + 2 * kv + B * H * L * 4),
            (6.0 * pairs * H * D, 3 * q + 2 * kv + rows),
            (8.0 * pairs * H * D, 2 * q + 4 * kv + rows)]


def grouped_products(rows: int, groups: int, dim: int, width: int,
                     esz: int = 2) -> list:
    """``[(operations, bytes)]`` of the six grouped products of one layer
    call: ``rows`` pairs, ``groups`` experts with ``w_gate_up [2·width,
    dim]`` and ``w_down [dim, width]``."""
    out = []
    for n, k in ((2 * width, dim), (dim, width)):
        ops = 2.0 * rows * n * k
        w = groups * n * k
        out += [(ops, esz * (rows * k + w + rows * n)),     # forward
                (ops, esz * (rows * n + w + rows * k)),     # input grad
                (ops, esz * (rows * k + rows * n + w))]     # weight grad
    return out


def expert_flops_per_pair(kw: dict) -> float:
    """A routed pair's training operations: its SwiGLU's three products,
    three times."""
    return 3.0 * 6 * int(kw["dim"]) * int(kw["expert_dim"])


def train_flops_per_token(kw: dict, length: int) -> float:
    d, H, Hkv = int(kw["dim"]), int(kw["heads"]), int(kw["kv_heads"])
    D, depth = int(kw["head_dim"]), int(kw["depth"])
    types = kw.get("layer_types") or [
        "full_attention" if (i + 1) % 4 == 0 else "sliding_attention"
        for i in range(depth)]
    per = 2 * d * int(kw["vocab"])
    for i, kind in enumerate(types):
        window = int(kw["window"]) if kind == "sliding_attention" else None
        keys = band_pairs(1, length, window) / length
        per += 2 * d * (2 * H + 2 * Hkv) * D + 2 * H * D * d
        per += 4 * keys * H * D
        if i < int(kw["dense_layers"]):
            per += 6 * d * int(kw["mlp_dim"])
        else:
            per += 2 * d * int(kw["experts"]) + 6 * d * int(kw["expert_dim"])
    return 3.0 * per
