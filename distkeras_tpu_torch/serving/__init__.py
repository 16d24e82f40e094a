"""Serving tier: continuous-batching generation over a block-paged KV cache.

- :mod:`~distkeras_tpu_torch.serving.paged_cache` — the block pool
  (:class:`BlockAllocator`, :class:`PagedKVCache`) and per-row sampling;
- :mod:`~distkeras_tpu_torch.serving.scheduler` — :class:`GenerationEngine`,
  iteration-level continuous batching with FIFO admission;
- :mod:`~distkeras_tpu_torch.serving.server` — :class:`GenerationServer` /
  :class:`GenerationClient` on the restricted-pickle framing.
"""

from distkeras_tpu_torch.serving.paged_cache import (
    BlockAllocator,
    BlockPoolExhausted,
    PagedKVCache,
    slot_map,
)
from distkeras_tpu_torch.serving.scheduler import (
    GenerationEngine,
    Request,
    per_row_new_token_counts,
)
from distkeras_tpu_torch.serving.server import (
    GenerationClient,
    GenerationServer,
)

__all__ = [
    "BlockAllocator",
    "BlockPoolExhausted",
    "PagedKVCache",
    "slot_map",
    "GenerationEngine",
    "Request",
    "per_row_new_token_counts",
    "GenerationClient",
    "GenerationServer",
]
