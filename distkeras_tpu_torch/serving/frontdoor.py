"""The serving front door: radix prefix cache and SLO-aware tenant admission.

Port of ``distkeras_tpu/serving/frontdoor.py``: two host-side structures
the scheduler composes into vLLM-lineage automatic prefix caching and
multi-tenant admission.

- :class:`RadixPrefixCache` — a content-hash radix tree over FULL KV
  blocks. Each node is one block of ``block_size`` token ids, keyed by a
  chain hash (``sharding/ring.py::stable_hash``, the pinned ``blake2b``:
  every process hashes a shared system prompt identically) of its tokens
  and its ancestry, and owns one :class:`BlockAllocator` block holding
  those positions' K/V. A request whose prompt starts with a cached chain
  maps the prefix into its block table and prefills only the uncached
  suffix; a request diverging MID-block copies the shared block's common
  slots into a fresh private block (copy-on-write) instead of recomputing
  them. Nodes are refcounted by the requests pinning them; eviction takes
  refcount-0 LEAVES in LRU order, so a shared system prompt's root blocks
  outlive any one conversation.

- :class:`TenantQueues` — per-tenant FIFO queues bucketed by ``slo_class``
  priority, in place of the global strict-FIFO deque under
  ``admission="slo"``. Admission serves the highest-priority class first
  and round-robins across tenants within a class; within one tenant order
  stays FIFO. The head candidate is never skipped: when it cannot fit,
  admission stops after trying preemption-by-recompute against
  strictly-lower-priority running rows.

Neither class touches the device or takes locks: the engine calls both
under its scheduler lock, on the scheduler thread, like the allocator
they sit beside. Pure Python and numpy, equal in behaviour to the JAX
package's.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from distkeras_tpu_torch.sharding.ring import stable_hash

__all__ = ["RadixPrefixCache", "TenantQueues", "PrefixMatch",
           "SLO_PRIORITY", "slo_priority"]

#: slo_class → admission priority (lower = served first). A class the map
#: does not name gets the "default" priority: an unknown label is
#: ordinary traffic, not an error.
SLO_PRIORITY = {
    "realtime": 0,
    "interactive": 1,
    "default": 2,
    "batch": 3,
    "best_effort": 4,
}


def slo_priority(slo_class: str) -> int:
    return SLO_PRIORITY.get(str(slo_class), SLO_PRIORITY["default"])


class _Node:
    """One full KV block in the radix tree."""

    __slots__ = ("tokens", "block", "parent", "children", "refs",
                 "last_used", "key")

    def __init__(self, tokens: tuple, block: int, parent, key: int):
        self.tokens = tokens          # the block's token ids (len == bs)
        self.block = int(block)       # the pool block holding their K/V
        self.parent = parent          # _Node or the root sentinel
        self.children: dict[int, _Node] = {}   # chain hash → child
        self.refs = 0                 # active requests pinning this node
        self.last_used = 0            # LRU clock tick of the last pin
        self.key = key                # this node's own chain hash


class PrefixMatch:
    """Result of :meth:`RadixPrefixCache.match`: the matched full-block
    chain (PINNED: the caller owns one reference on each node and must
    :meth:`~RadixPrefixCache.release` them at retire) plus an optional
    copy-on-write candidate ``(cow_node, cow_len)``: a sibling block
    sharing the first ``cow_len`` tokens of the divergent block, whose
    slots the engine copies into a fresh private block instead of
    recomputing them. ``tokens`` counts everything served from cache
    (``len(nodes) · block_size + cow_len``)."""

    __slots__ = ("nodes", "cow_node", "cow_len")

    def __init__(self, nodes, cow_node=None, cow_len: int = 0):
        self.nodes = list(nodes)
        self.cow_node = cow_node
        self.cow_len = int(cow_len)

    def tokens(self, block_size: int) -> int:
        return len(self.nodes) * int(block_size) + self.cow_len

    @property
    def blocks(self) -> list[int]:
        return [n.block for n in self.nodes]


class RadixPrefixCache:
    """Content-hash radix tree mapping token-id block chains to pool blocks.

    The tree does not allocate: block ownership is transferred in by
    :meth:`insert` (a request donates the prompt blocks it just prefilled)
    and back out by :meth:`evict`/:meth:`flush` (the blocks return to the
    caller, who frees them into the allocator). Between the two the
    engine's accounting invariant is::

        allocator.used_blocks == Σ slots' private blocks + cache.total_blocks
    """

    def __init__(self, block_size: int):
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._root = _Node((), -1, None, stable_hash("radix:root"))
        self._nodes: list[_Node] = []   # every live node (eviction scan)
        self._clock = 0                 # LRU tick
        self.hits = 0                   # match() calls that found ≥1 token
        self.misses = 0
        self.evictions = 0
        self.inserted = 0

    def _chain_key(self, parent: _Node, tokens: tuple) -> int:
        ids = ",".join(str(int(t)) for t in tokens)
        return stable_hash(f"radix:{parent.key}:{ids}")

    @property
    def total_blocks(self) -> int:
        return len(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def match(self, tokens, max_tokens: int) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``max_tokens``
        served positions (the engine caps a fresh request at ``len(prompt)
        - 1``: it must feed the last prompt token to get logits to sample
        from). Matched full-block nodes come back PINNED; the COW
        candidate, if any, is not pinned here (the engine pins it until
        its slots are copied)."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        bs = self.block_size
        self._clock += 1
        node = self._root
        nodes: list[_Node] = []
        i = 0
        while i + bs <= len(toks) and (len(nodes) + 1) * bs <= max_tokens:
            blk = tuple(toks[i: i + bs])
            child = node.children.get(self._chain_key(node, blk))
            if child is None or child.tokens != blk:
                break        # hash miss (or collision: the token check)
            child.refs += 1
            child.last_used = self._clock
            nodes.append(child)
            node = child
            i += bs
        # partial-block divergence: a sibling sharing m > 0 leading tokens
        # of the next block is a copy-on-write candidate — its first m
        # slots are this request's positions i .. i+m-1
        cow_node, cow_len = None, 0
        rest = toks[i:]
        if rest:
            budget = max_tokens - len(nodes) * bs
            for child in node.children.values():
                m = 0
                for a, b in zip(child.tokens, rest):
                    if a != b:
                        break
                    m += 1
                m = min(m, budget)
                if m > cow_len or (m == cow_len and m > 0
                                   and child.block <
                                   (cow_node.block if cow_node else 1 << 62)):
                    cow_node, cow_len = child, m
            if cow_len <= 0:
                cow_node, cow_len = None, 0
            else:
                cow_node.last_used = self._clock
        if nodes or cow_len:
            self.hits += 1
        else:
            self.misses += 1
        return PrefixMatch(nodes, cow_node, cow_len)

    def release(self, nodes) -> None:
        """Drop one reference per node (a retired request unpinning its
        chain). The blocks stay cached until eviction needs them."""
        for n in nodes:
            if n.refs <= 0:
                raise ValueError(
                    f"release of unpinned radix node (block {n.block})")
            n.refs -= 1

    def insert(self, tokens, blocks) -> tuple[list, list[int]]:
        """Register a prefilled prompt's full blocks: ``blocks[k]`` holds
        positions ``k·bs .. (k+1)·bs - 1`` of ``tokens``. Where a node
        already exists along the chain (the request's own pinned prefix,
        or a twin inserted first) the offered block is not adopted and
        stays the request's; where the chain ends, a new node adopts the
        offered block and comes back pinned for the inserting request.
        Returns ``(new_nodes, adopted_blocks)``."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        bs = self.block_size
        if len(blocks) * bs > len(toks):
            raise ValueError(
                f"{len(blocks)} blocks cover {len(blocks) * bs} tokens but "
                f"the prompt has only {len(toks)}")
        self._clock += 1
        node = self._root
        new_nodes: list[_Node] = []
        adopted: list[int] = []
        for k, block in enumerate(blocks):
            blk = tuple(toks[k * bs: (k + 1) * bs])
            key = self._chain_key(node, blk)
            child = node.children.get(key)
            if child is not None and child.tokens == blk:
                child.last_used = self._clock
                node = child
                continue
            if child is not None:
                # chain-hash collision with other tokens: leave the
                # incumbent alone and stop growing this path
                break
            child = _Node(blk, block, node, key)
            child.refs = 1
            child.last_used = self._clock
            node.children[key] = child
            self._nodes.append(child)
            new_nodes.append(child)
            adopted.append(int(block))
            self.inserted += 1
            node = child
        return new_nodes, adopted

    def _evictable(self):
        return [n for n in self._nodes if n.refs == 0 and not n.children]

    def evict(self, n_blocks: int) -> list[int]:
        """Free up to ``n_blocks`` cached blocks, LRU refcount-0 leaves
        first (freeing a leaf can expose its parent as the next leaf).
        Returns the freed block ids; the caller frees them."""
        freed: list[int] = []
        while len(freed) < int(n_blocks):
            cands = self._evictable()
            if not cands:
                break
            victim = min(cands, key=lambda n: (n.last_used, n.block))
            self._drop(victim)
            freed.append(victim.block)
            self.evictions += 1
        return freed

    def flush(self) -> list[int]:
        """Evict everything evictable (refcount-0 subtrees, leaves first)
        and return the freed block ids. Pinned chains survive."""
        freed: list[int] = []
        while True:
            batch = self.evict(len(self._nodes) or 1)
            if not batch:
                return freed
            freed.extend(batch)

    def _drop(self, node: _Node) -> None:
        node.parent.children.pop(node.key, None)
        self._nodes.remove(node)


class TenantQueues:
    """Per-tenant FIFO queues bucketed by SLO-class priority.

    ``push`` appends to the request's ``(priority, tenant)`` queue;
    ``candidate`` returns (without popping) the request admission should
    try next: the highest-priority non-empty class, round-robin across its
    tenants (each ``pop`` advances that class's rotation), FIFO within one
    tenant. ``push_front`` re-queues a preempted or refilled request at
    its tenant's head so recompute happens in admission order."""

    def __init__(self):
        self._q: dict[int, dict[str, deque]] = {}   # prio → tenant → queue
        self._rr: dict[int, deque] = {}             # prio → tenant rotation
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _bucket(self, req) -> tuple[int, str]:
        return slo_priority(req.slo_class), str(
            getattr(req, "tenant", "default"))

    def push(self, req) -> None:
        prio, tenant = self._bucket(req)
        by_tenant = self._q.setdefault(prio, {})
        if tenant not in by_tenant:
            by_tenant[tenant] = deque()
            self._rr.setdefault(prio, deque()).append(tenant)
        by_tenant[tenant].append(req)
        self._n += 1

    def push_front(self, req) -> None:
        prio, tenant = self._bucket(req)
        by_tenant = self._q.setdefault(prio, {})
        if tenant not in by_tenant:
            by_tenant[tenant] = deque()
            # a re-queued request's tenant goes to the FRONT of the
            # rotation: recompute before fresh same-class admissions
            self._rr.setdefault(prio, deque()).appendleft(tenant)
        by_tenant[tenant].appendleft(req)
        self._n += 1

    def candidate(self):
        """The next request admission should try, or None. Does not pop."""
        for prio in sorted(self._q):
            rr = self._rr.get(prio)
            if not rr:
                continue
            for _ in range(len(rr)):
                tenant = rr[0]
                q = self._q[prio].get(tenant)
                if q:
                    return q[0]
                rr.rotate(-1)   # empty tenant: look at the next one
        return None

    def pop(self, req) -> None:
        """Pop ``req``, which must be its tenant queue's head, and advance
        the class rotation so the next candidate is the next tenant."""
        prio, tenant = self._bucket(req)
        q = self._q.get(prio, {}).get(tenant)
        if not q or q[0] is not req:
            raise ValueError(f"pop of non-head request {req.id}")
        q.popleft()
        self._n -= 1
        rr = self._rr.get(prio)
        if rr and rr[0] == tenant:
            rr.rotate(-1)

    def remove(self, req) -> bool:
        """Remove a request from anywhere in its queue."""
        prio, tenant = self._bucket(req)
        q = self._q.get(prio, {}).get(tenant)
        if q is None:
            return False
        try:
            q.remove(req)
        except ValueError:
            return False
        self._n -= 1
        return True

    def drain(self) -> list:
        """Pop everything, priority-then-rotation order (engine teardown)."""
        out = []
        while self._n:
            req = self.candidate()
            if req is None:   # pragma: no cover — _n and queues disagree
                break
            self.pop(req)
            out.append(req)
        return out

    def __iter__(self):
        for prio in sorted(self._q):
            for q in self._q[prio].values():
                yield from q
