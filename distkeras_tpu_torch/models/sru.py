"""SRU sequence classifier: the recurrence with no matmul inside it. Port
of ``distkeras_tpu/models/sru.py``.

The Simple Recurrent Unit (Lei et al. 2018) moves every matmul out of the
recurrence:

    x̃_t, f_t, r_t  =  split(x_t @ W)          (one [B·T, E]·[E, 3H] matmul)
    c_t  =  f_t ⊙ c_{t-1} + (1 − f_t) ⊙ x̃_t   (elementwise, linear in c)
    h_t  =  r_t ⊙ g(c_t) + (1 − r_t) ⊙ x_t    (highway output)

The cell update is a first-order linear recurrence, and such recurrences
compose associatively: ``(f₁, g₁)∘(f₂, g₂) = (f₁f₂, f₂g₁ + g₂)``. PyTorch
has no stable associative scan, so ``impl="assoc"`` runs ⌈log₂T⌉
out-of-place doubling steps over that composition (Hillis–Steele) in
plain PyTorch: the same values as the JAX package's
``lax.associative_scan`` tree up to rounding, in log depth.
``impl="scan"`` is the sequential oracle. The JAX SRU has no Pallas
kernel, and neither has this one.

Same classifier interface as ``models.lstm`` (padded tokens + mask,
masked-mean pooling), so it drops into the IMDB configuration unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import Dense, Embed


def sru_recurrence(gates, impl: str = "assoc"):
    """Run the SRU cell update over time. ``gates``: ``[B, T, 3H]`` packed
    ``(x̃, pre_f, pre_r)`` projections → ``(c [B, T, H], r [B, T, H])``,
    both f32."""
    H = gates.shape[-1] // 3
    xt = gates[..., :H].to(torch.float32)
    f = torch.sigmoid(gates[..., H:2 * H].to(torch.float32))
    r = torch.sigmoid(gates[..., 2 * H:].to(torch.float32))
    g = (1.0 - f) * xt      # the additive term of c_t = f·c_{t-1} + g_t

    if impl == "assoc":
        # after the step of span k, (f[t], g[t]) composes steps t-2k+1..t;
        # no closed form through cumprod/cumsum: it divides by products
        # of gates that underflow
        T, k = f.shape[1], 1
        while k < T:
            f, g = (torch.cat([f[:, :k], f[:, k:] * f[:, :-k]], dim=1),
                    torch.cat([g[:, :k], f[:, k:] * g[:, :-k] + g[:, k:]],
                              dim=1))
            k *= 2
        c = g
    elif impl == "scan":
        c_t = torch.zeros_like(f[:, 0])
        cs = []
        for t in range(f.shape[1]):
            c_t = f[:, t] * c_t + g[:, t]
            cs.append(c_t)
        c = torch.stack(cs, dim=1)
    else:
        raise ValueError(f"unknown SRU impl {impl!r}; use 'assoc' or 'scan'")
    return c, r


class SRUClassifier(nn.Module):
    """``(tokens [B, T], mask [B, T]) → logits [B, num_classes]`` (f32)
    through ``depth`` SRU layers. Parameters carry flax's names:
    ``Embed_0``, ``w_{l}`` (the three gates' projection), ``skip_{l}``
    (the highway's projection, only where the widths differ), ``Dense_0``.
    """

    def __init__(self, vocab: int = 20000, embed_dim: int = 128,
                 hidden_dim: int = 128, num_classes: int = 2, depth: int = 1,
                 dtype=torch.bfloat16, impl: str = "assoc"):
        super().__init__()
        if impl not in ("assoc", "scan"):
            raise ValueError(
                f"unknown SRU impl {impl!r}; use 'assoc' or 'scan'")
        self.dtype, self.impl = dtype, impl
        self.depth, self.hidden_dim = depth, hidden_dim
        self.Embed_0 = Embed(vocab, embed_dim, dtype)
        width = embed_dim
        for layer in range(depth):
            self.add_module(f"w_{layer}", Dense(width, 3 * hidden_dim, dtype))
            if width != hidden_dim:
                self.add_module(f"skip_{layer}",
                                Dense(width, hidden_dim, dtype))
            width = hidden_dim
        self.Dense_0 = Dense(hidden_dim, num_classes, dtype)

    def reset_parameters(self, generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, tokens, mask=None):
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        x = self.Embed_0(tokens)
        for layer in range(self.depth):
            gates = getattr(self, f"w_{layer}")(x)            # [B, T, 3H]
            c, r = sru_recurrence(gates, impl=self.impl)
            skip = x.to(torch.float32)
            if skip.shape[-1] != self.hidden_dim:
                skip = getattr(self, f"skip_{layer}")(x).to(torch.float32)
            x = (r * torch.tanh(c) + (1.0 - r) * skip).to(self.dtype)
        m = mask.to(torch.float32)[..., None]
        pooled = torch.sum(x.to(torch.float32) * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0)
        return self.Dense_0(pooled.to(self.dtype)).to(torch.float32)


def sru_classifier(vocab=20000, maxlen=200, embed_dim=128, hidden_dim=128,
                   num_classes=2, depth=1, dtype=torch.bfloat16,
                   impl="assoc") -> ModelSpec:
    """Drop-in alternative to :func:`models.lstm.lstm_classifier` whose
    recurrence parallelizes over time: the same ``(tokens, mask)`` inputs
    (``features_col=["features", "mask"]``)."""
    module = SRUClassifier(vocab=vocab, embed_dim=embed_dim,
                           hidden_dim=hidden_dim, num_classes=num_classes,
                           depth=depth, dtype=dtype, impl=impl)
    example = (torch.zeros((1, maxlen), dtype=torch.int64),
               torch.ones((1, maxlen), dtype=torch.float32))
    return from_module(module, name="sru_classifier", example=example)
