"""The causal LM's training operations a token (``bench.py``'s
``lm_train_flops_per_token``, with causal attention counted at the half
the inputs need): three times the forward's matrix products, each block's
q|k|v, output and MLP projections (24·d²) and its attention's QKᵀ and AV
over the keys a causal query sees on average (2·L·d), plus the head
(2·d·V). Recomputation (the flash backward's) is not counted."""


def train_flops_per_token(dim: int, depth: int, length: int,
                          vocab: int) -> float:
    return 3.0 * (depth * (24 * dim * dim + 2 * length * dim)
                  + 2 * dim * vocab)
