"""Serving tier: continuous-batching generation over a block-paged KV cache.

- :mod:`~distkeras_tpu_torch.serving.paged_cache` — the block pool
  (:class:`BlockAllocator`, :class:`PagedKVCache`) and per-row sampling;
- :mod:`~distkeras_tpu_torch.serving.frontdoor` — the front door's host
  structures: :class:`RadixPrefixCache` (prefix sharing with
  copy-on-write) and :class:`TenantQueues` (SLO-class admission);
- :mod:`~distkeras_tpu_torch.serving.scheduler` — :class:`GenerationEngine`,
  iteration-level continuous batching, FIFO or through the front door
  (``prefix_cache``, ``prefill_chunk``, ``admission="slo"``), with the
  ``swap_params`` weight-swap gate;
- :mod:`~distkeras_tpu_torch.serving.server` — :class:`GenerationServer` /
  :class:`GenerationClient` on the restricted-pickle framing.
"""

from distkeras_tpu_torch.serving.frontdoor import (
    SLO_PRIORITY,
    PrefixMatch,
    RadixPrefixCache,
    TenantQueues,
    slo_priority,
)
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
    "SLO_PRIORITY",
    "PrefixMatch",
    "RadixPrefixCache",
    "TenantQueues",
    "slo_priority",
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
