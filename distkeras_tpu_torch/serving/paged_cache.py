"""Block-paged KV cache: one preallocated pool per layer, many sequences.

Port of ``distkeras_tpu/serving/paged_cache.py``. The pool is carved into
``block_size``-slot blocks; every sequence owns a block table mapping its
logical positions to pool blocks (PagedAttention, Kwon et al. SOSP '23), so
concurrent requests of any length share one preallocated cache and
admission is a host-side allocator decision. :class:`BlockAllocator` is the
host free-list (block 0 is the scratch block free rows and unallocated
table entries point at); :class:`PagedKVCache` holds the per-layer flat
``[num_blocks·block_size, Hkv, Dh]`` pools, updated in place by the model's
``paged_extend`` (``index_copy_``, never a whole-pool copy).
"""

from __future__ import annotations

import numpy as np
import torch


class BlockPoolExhausted(RuntimeError):
    """The allocator has fewer free blocks than the request needs. Internal
    to the scheduler: admission waits until retirements free blocks."""


class BlockAllocator:
    """Host-side free-list over the block pool. Block 0 is the reserved
    scratch block; capacity is ``num_blocks - 1``. Deterministic: blocks
    are handed out lowest-id-first and returned in sorted order."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is scratch), "
                             f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() → block 1
        self._allocated: set[int] = set()
        self.high_water = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._allocated)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise BlockPoolExhausted(f"need {n} blocks, {len(self._free)} "
                                     f"free (capacity {self.capacity})")
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        self.high_water = max(self.high_water, len(self._allocated))
        return blocks

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double-free or foreign block {b} "
                                 f"(allocated: {len(self._allocated)} blocks)")
            self._allocated.discard(b)
            self._free.append(b)
        self._free.sort(reverse=True)  # keep pop() order deterministic


class PagedKVCache:
    """Per-layer flat slot pools ``[num_blocks · block_size, Hkv, Dh]`` in
    the model dtype, on the model's device."""

    def __init__(self, module, num_blocks: int, block_size: int):
        hkv = module.kv_heads if module.kv_heads is not None \
            else module.heads
        dh = module.dim // module.heads
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_slots = self.num_blocks * self.block_size
        shape = (self.num_slots, hkv, dh)
        kw = dict(dtype=module.dtype, device=module.device)
        self.k_pools = tuple(torch.zeros(shape, **kw)
                             for _ in range(module.depth))
        self.v_pools = tuple(torch.zeros(shape, **kw)
                             for _ in range(module.depth))


def slot_map(tables: np.ndarray, block_size: int) -> np.ndarray:
    """Flatten block tables ``[B, nb]`` into per-position pool slots
    ``[B, nb·bs]``: ``slots[b, t] = tables[b, t // bs] · bs + t % bs``."""
    bs = int(block_size)
    nb = tables.shape[1]
    return (np.repeat(tables, bs, axis=1) * bs
            + np.tile(np.arange(bs, dtype=tables.dtype), nb))


def warp_rows(logits, temperature, top_k, top_p, greedy):
    """Per-row logit warping: temperature scale → top-k → minimal nucleus
    (ties at a boundary survive), filtered tokens at -1e30 — the filter of
    the JAX package's ``sample_rows``. Row parameters are tensors on the
    logits' device; greedy rows warp at temperature 1 (their sample is
    discarded)."""
    V = logits.shape[-1]
    logits = logits.to(torch.float32)
    temp = torch.where(greedy, torch.ones_like(temperature),
                       torch.clamp(temperature, min=1e-6))
    scaled = logits / temp[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(top_k - 1, 0, V - 1)[:, None]
                       .to(torch.int64))
    scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30), scaled)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    cutoff = torch.where(keep, desc, torch.full_like(desc, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    return torch.where(scaled < cutoff, torch.full_like(scaled, -1e30),
                       scaled)


def _stream_seed(seed: int, position: int) -> int:
    """One generator seed per (request seed, absolute position), mixed so
    that its low 32 bits (all the CPU generator keeps) depend on both."""
    h = (int(seed) * 0x9E3779B97F4A7C15
         + int(position) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    return (h ^ (h >> 32)) & 0x7FFFFFFFFFFFFFFF


def sample_rows(logits, temperature, top_k, top_p, greedy, seeds,
                positions):
    """Per-row sampling inside one batched step → int64 tokens ``[B]`` on
    the logits' device. Greedy rows take ``argmax`` of the raw logits;
    other rows draw from ``softmax(warp_rows(...))`` with a
    ``torch.Generator`` seeded from (request seed, position), so a stream
    is deterministic per seed whatever batch row it lands in. Row
    parameters are host numpy arrays."""
    dev = logits.device
    greedy_tok = torch.argmax(logits.to(torch.float32), dim=-1)
    greedy = np.asarray(greedy, bool)
    if greedy.all():
        return greedy_tok
    warped = warp_rows(
        logits,
        torch.as_tensor(np.asarray(temperature, np.float32), device=dev),
        torch.as_tensor(np.asarray(top_k, np.int64), device=dev),
        torch.as_tensor(np.asarray(top_p, np.float32), device=dev),
        torch.as_tensor(greedy, device=dev),
    )
    probs = torch.softmax(warped, dim=-1)
    out = greedy_tok.clone()
    for b in np.flatnonzero(~greedy):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_stream_seed(seeds[b], positions[b]))
        out[b] = torch.multinomial(probs[b], 1, generator=gen)[0]
    return out
