"""Consistent-hash partitioning of the parameter tree across PS shards.

Port of ``distkeras_tpu/sharding/ring.py`` (numpy and hashlib only): WHICH
leaf lives on WHICH shard, decided once per model and stable across runs,
processes, both packages and (mostly) shard-count changes.

- **Keys are leaf paths**, written as ``jax.tree_util.keystr`` writes them
  (``utils.flatten_with_paths`` reproduces it character for character), so
  a worker of either package derives the same plan from the same tree.
- **Hashing is pinned**: ``blake2b`` over the path string, never Python's
  salted ``hash()``.
- **Byte-weighted, bounded-load placement**: leaves place in descending
  size onto their ring successor, walking past shards whose byte load
  would exceed ``bound × total/num_shards`` (consistent hashing with
  bounded loads, Mirrokni et al. 2017); a leaf bigger than the cap lands
  on the first empty shard of its walk.
- **Minimal movement on resharding**: only the ring points of added or
  removed shards change, so a leaf moves only when its successor walk does.

``ShardPlan`` is the run-time artifact: paths, structure and assignment,
with ``split``/``join`` to scatter a commit payload (a raw tree or an
encoded codec blob, whose ``__dk_leaf__`` nodes split as units) across
shards and gather the pulled parts back into the full tree.
"""

from __future__ import annotations

import hashlib
import struct
from bisect import bisect_left
from typing import Any, Iterator

import numpy as np

from distkeras_tpu_torch import utils
from distkeras_tpu_torch.parallel.compression import _LEAF, _MARK, is_encoded

Tree = Any


def stable_hash(key: str) -> int:
    """64-bit pinned hash of a string (blake2b: the same in every process;
    the builtin ``hash`` is salted per interpreter)."""
    return struct.unpack(
        ">Q", hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest()
    )[0]


class HashRing:
    """Consistent-hash ring over ``num_shards`` shards with ``vnodes``
    virtual nodes a shard (64 keeps the arcs even enough that the
    bounded-load walk, not the ring's geometry, sets the byte balance)."""

    def __init__(self, num_shards: int, vnodes: int = 64):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.num_shards = int(num_shards)
        self.vnodes = int(vnodes)
        pts = sorted(
            (stable_hash(f"shard:{sid}/vnode:{v}"), sid)
            for sid in range(self.num_shards)
            for v in range(self.vnodes)
        )
        self._hashes = [h for h, _ in pts]
        self._owners = [sid for _, sid in pts]

    def successors(self, h: int) -> Iterator[int]:
        """Distinct shard ids clockwise from ring position ``h``, each
        once: the bounded-load walk's order."""
        n = len(self._hashes)
        seen: set[int] = set()
        i = bisect_left(self._hashes, h)
        for k in range(n):
            sid = self._owners[(i + k) % n]
            if sid not in seen:
                seen.add(sid)
                yield sid
                if len(seen) == self.num_shards:
                    return

    def assign(self, sizes: dict[str, int],
               bound: float = 1.25) -> dict[str, int]:
        """Byte-weighted bounded-load assignment ``{path: shard_id}``.

        Leaves place in descending bytes (path breaks ties), each onto the
        first shard of its successor walk whose load stays under ``bound ×
        total/num_shards``, or the first EMPTY shard for a leaf bigger than
        that cap. A last pass gives every shard at least one leaf (the
        smallest leaves move off the fullest shards), so it needs
        ``num_shards <= len(sizes)``."""
        if bound <= 1.0:
            raise ValueError(f"bound must be > 1, got {bound}")
        if not sizes:
            raise ValueError("cannot shard an empty tree")
        if self.num_shards > len(sizes):
            raise ValueError(
                f"cannot spread {len(sizes)} leaves over "
                f"{self.num_shards} shards (each shard must own >= 1 leaf)")
        total = float(sum(sizes.values()))
        cap = bound * total / self.num_shards
        loads = [0.0] * self.num_shards
        counts = [0] * self.num_shards
        out: dict[str, int] = {}
        for path, size in sorted(sizes.items(), key=lambda kv: (-kv[1], kv[0])):
            placed = None
            for sid in self.successors(stable_hash(f"leaf:{path}")):
                if loads[sid] == 0.0 or loads[sid] + size <= cap:
                    placed = sid
                    break
            if placed is None:
                # every shard past the cap (degenerate sizes): the least
                # loaded, deterministically
                placed = min(range(self.num_shards),
                             key=lambda s: (loads[s], s))
            out[path] = placed
            loads[placed] += size
            counts[placed] += 1
        for sid in range(self.num_shards):
            if counts[sid]:
                continue
            donor = max(
                (s for s in range(self.num_shards) if counts[s] > 1),
                key=lambda s: (loads[s], -s))
            path = min((p for p, s in out.items() if s == donor),
                       key=lambda p: (sizes[p], p))
            out[path] = sid
            loads[donor] -= sizes[path]
            loads[sid] += sizes[path]
            counts[donor] -= 1
            counts[sid] += 1
        return out


def _is_codec_leaf(node) -> bool:
    return isinstance(node, dict) and _LEAF in node


def _flatten_with_paths(tree: Tree):
    """``[(path, node)], structure`` in canonical order, encoded codec
    leaves kept whole: a raw tree and its encoded blob flatten to the same
    path list."""
    return utils.flatten_with_paths(tree, is_leaf=_is_codec_leaf)


class ShardPlan:
    """The frozen sharding of one model: paths, structure, assignment.

    Every participant (shard servers, each worker's client, the WAL
    verifier) derives the same plan from the same template; ``digest``
    pins that agreement and travels in the shard-map handshake, so a
    client wired to servers sharded under another plan fails fast instead
    of folding leaves into the wrong shard."""

    def __init__(self, template: Tree, num_shards: int,
                 vnodes: int = 64, bound: float = 1.25):
        pairs, self.treedef = _flatten_with_paths(template)
        self.paths = [p for p, _ in pairs]
        if len(set(self.paths)) != len(self.paths):
            raise ValueError("duplicate leaf paths in the template tree")
        self.sizes = {p: int(np.asarray(node).nbytes) for p, node in pairs}
        self.ring = HashRing(num_shards, vnodes=vnodes)
        self.bound = float(bound)
        self.assignment = self.ring.assign(self.sizes, bound=bound)
        self.num_shards = int(num_shards)
        self.shard_paths = [
            [p for p in self.paths if self.assignment[p] == sid]
            for sid in range(self.num_shards)
        ]
        self.shard_nbytes = [
            sum(self.sizes[p] for p in paths) for paths in self.shard_paths
        ]
        h = hashlib.sha1()
        for p in self.paths:
            h.update(f"{p}={self.assignment[p]};".encode("utf-8"))
        self.digest = h.hexdigest()

    # -- scatter / gather ------------------------------------------------------

    def _leaf_map(self, tree: Tree) -> dict[str, Any]:
        pairs, _ = _flatten_with_paths(tree)
        got = [p for p, _ in pairs]
        if got != self.paths:
            raise ValueError(
                f"tree structure does not match the shard plan "
                f"({len(got)} leaves vs {len(self.paths)} expected)")
        return dict(pairs)

    def shard_template(self, tree: Tree, sid: int) -> dict[str, Any]:
        """Shard ``sid``'s sub-center: a flat ``{path: leaf}`` dict, an
        ordinary tree that the shard server folds with the same leafwise
        ``MergeRule.fold`` as the full one (which is what makes an N-shard
        run bit-identical to the single-PS run)."""
        leaf_map = self._leaf_map(tree)
        return {p: leaf_map[p] for p in self.shard_paths[sid]}

    def split(self, payload: Tree) -> list:
        """One commit payload as per-shard payloads: the raw tree, or an
        encoded codec blob (``{__dk_codec__: name, "tree": ...}``) whose
        leaf nodes split as units, so each sub-blob decodes server-side as
        the whole blob would have (the codecs are leafwise)."""
        wrap = None
        if is_encoded(payload):
            wrap = payload[_MARK]
            payload = payload["tree"]
        leaf_map = self._leaf_map(payload)
        parts = [{p: leaf_map[p] for p in self.shard_paths[sid]}
                 for sid in range(self.num_shards)]
        if wrap is not None:
            parts = [{_MARK: wrap, "tree": part} for part in parts]
        return parts

    def join(self, parts: list) -> Tree:
        """Per-shard ``{path: leaf}`` dicts (decoded) gathered back into the
        full tree in canonical leaf order."""
        merged: dict[str, Any] = {}
        for part in parts:
            merged.update(part)
        missing = [p for p in self.paths if p not in merged]
        if missing:
            raise ValueError(
                f"shard reassembly is missing {len(missing)} leaves (first: "
                f"{missing[0]!r}): a shard reply was dropped or the plans "
                f"disagree")
        return utils.unflatten(self.treedef, [merged[p] for p in self.paths])

    def shard_info(self, sid: int) -> dict:
        """The shard-map handshake record a shard server advertises."""
        return {"shard_id": int(sid), "num_shards": self.num_shards,
                "ring": self.digest}
